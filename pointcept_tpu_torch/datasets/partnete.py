"""PartNetE (counterpart of `pointcept_tpu/datasets/partnete.py`; parity
target: reference `pointcept/datasets/partnete.py`): category-conditioned
part segmentation (the PartSLIP benchmark). Each category's parts take a
block of the global label space (`num_part_offset`), part 0 of each block
its "other" part; a sample is a folder of npy assets,
``<data_root>/<split>/<category>/<id>/``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

VALID_ASSETS = ("coord", "color", "normal", "segment", "instance")


@DATASETS.register_module()
class PartNetEDataset(DefaultDataset):
    """`class_names` and `num_parts` (each category's parts, "other"
    included) lay out the label blocks; the meta json at `meta_path` names
    each category's parts after "other" (`parts`). A sample's ``segment``
    is its local part id + the category's offset + 1, ``cls_token`` its
    category's index. The configs of the repository name none of
    `class_names`, `num_parts` and `meta_path`: building their dataset raises
    a TypeError naming them."""

    def __init__(self, class_names, num_parts, data_root, meta_path, split, **kwargs):
        self.categories = list(class_names)
        self.num_parts = list(num_parts)
        self.num_part_offset = np.concatenate(([0], np.cumsum(self.num_parts)))
        self.category2part = {}
        self.parts = []
        meta_data = {}
        if meta_path and os.path.isfile(meta_path):
            with open(meta_path, "r", encoding="utf-8") as f:
                meta_data = json.load(f)
        for class_id, class_name in enumerate(self.categories):
            self.category2part[class_name] = (self.num_part_offset[class_id]
                                              + np.arange(self.num_parts[class_id])).tolist()
            self.parts.extend(f"{class_name}_{p}" for p in ["other"] + list(meta_data.get(class_name, [])))
        super().__init__(data_root=data_root, split=split, **kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        return [p for split in splits for p in sorted(glob.glob(os.path.join(self.data_root, split, "*/*")))]

    def get_data_name(self, idx):
        dir_path, id_name = os.path.split(self.data_list[idx % len(self.data_list)])
        return f"{os.path.basename(dir_path)}_{id_name}"

    def get_data(self, idx):
        data_path = self.data_list[idx % len(self.data_list)]
        name = self.get_data_name(idx)
        data_dict = {}
        for asset in os.listdir(data_path):
            if asset.endswith(".npy") and asset[:-4] in VALID_ASSETS:
                data_dict[asset[:-4]] = np.load(os.path.join(data_path, asset))
        data_dict["name"] = name
        cls_token = self.categories.index(name.split("_")[0])
        data_dict["cls_token"] = cls_token
        for k in ("coord", "color", "normal"):
            if k in data_dict:
                data_dict[k] = data_dict[k].astype(np.float32)
        n = data_dict["coord"].shape[0]
        if "segment" in data_dict:
            data_dict["segment"] = (data_dict["segment"].reshape(-1).astype(np.int32)
                                    + self.num_part_offset[cls_token] + 1)
        else:
            data_dict["segment"] = np.full(n, -1, np.int32)
        if "instance" in data_dict:
            data_dict["instance"] = data_dict["instance"].reshape(-1).astype(np.int32)
        else:
            data_dict["instance"] = np.full(n, -1, np.int32)
        return data_dict
