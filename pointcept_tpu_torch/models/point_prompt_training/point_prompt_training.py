"""Point Prompt Training: multi-dataset joint training wrappers
(counterparts of `pointcept_tpu/models/point_prompt_training/`; reference
`pointcept/models/point_prompt_training/`).

A batch holds scenes of one dataset, its ``condition``. PPT-v1m1
(language-guided) looks the condition's context up in ``embedding_table``
and puts it on the batch for the backbone's PDNorm; its logits are
``exp(logit_scale)`` times the cosine between the projected features
(``proj_head``) and the text embeddings of the condition's classes (the
rows ``valid_index[condition]`` of the merged class list). PPT-v1m2
(decoupled) has the same context and one linear head a condition
(``seg_head{i}``). PPT-v1m3 (neo) keeps one class list a condition, no
context, and the up-cast of an ``enc_mode`` backbone; ``freeze_backbone``
freezes the backbone in the model (``requires_grad=False``), so no
optimizer group holds it and no graph is recorded through it.

The text embeddings are CLIP's in the reference. They load from
``class_embedding_path`` (an ``.npy`` exported with CLIP, row-normalised,
frozen) where the file exists; otherwise, as in the JAX package, the
wrapper trains a table drawn N(0, 0.02) (`init_weights`) and row-normalised
at use. A batch whose condition is not among the wrapper's raises, naming
both; so does a v1m3 batch that carries none.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..builder import MODELS
from ..losses import build_criteria
from ..modules import Linear
from ..point_transformer_v3.point_transformer_v3 import up_cast
from ..utils.structure import PointBatch

DEFAULT_CLASS_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "bookcase", "picture", "counter", "desk", "shelves", "curtain",
    "dresser", "pillow", "mirror", "ceiling", "refrigerator", "television", "shower curtain", "nightstand",
    "toilet", "sink", "lamp", "bathtub", "garbagebin", "board", "beam", "column",
    "clutter", "otherstructure", "otherfurniture", "otherprop",
)
DEFAULT_VALID_INDEX = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23, 25, 26, 33, 34, 35),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 20, 22, 24, 25, 27, 34),
    (0, 1, 4, 5, 6, 7, 8, 10, 19, 29, 30, 31, 32),
)
DEFAULT_NEO_CLASS_NAMES = (
    ("wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door", "window", "picture",
     "desk", "shelves", "curtain", "dresser", "pillow", "mirror", "ceiling", "refrigerator", "television",
     "nightstand", "sink", "lamp", "otherstructure", "otherfurniture", "otherprop"),
    ("wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
     "picture", "counter", "desk", "curtain", "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
     "otherfurniture"),
    ("ceiling", "floor", "wall", "beam", "column", "window", "door", "table", "chair", "sofa",
     "bookcase", "board", "clutter"),
)


def _condition_index(conditions: tuple, condition: Optional[str], name: str) -> int:
    if condition not in conditions:
        raise ValueError(f"{name}: the batch's condition {condition!r} is not among the model's conditions "
                         f"{conditions}")
    return conditions.index(condition)


class _PromptBase(nn.Module):
    """The backbone, criteria and condition bookkeeping the three share."""

    def __init__(self, backbone, criteria, backbone_out_channels: int, conditions: Sequence[str]):
        super().__init__()
        self.backbone = MODELS.build(dict(backbone))
        self.criteria = build_criteria(criteria)
        self.conditions = tuple(conditions)
        self.enc_mode = bool(getattr(self.backbone, "enc_mode", False))
        width = (sum(self.backbone.enc_channels) if self.enc_mode else self.backbone.out_channels)
        if backbone_out_channels != width:
            raise ValueError(f"{type(self).__name__}: backbone_out_channels={backbone_out_channels} but the "
                             f"backbone emits {width} channels")
        self.feat_channels = width

    def _backbone(self, pb: PointBatch, generator, precomputed):
        kw = {} if precomputed is None else dict(precomputed=precomputed)
        if self.enc_mode:
            out, diag, skips = self.backbone(pb, generator=generator, **kw)
            return up_cast(out, skips, len(skips)), diag
        return self.backbone(pb, generator=generator, **kw)

    def _result(self, pb: PointBatch, out: PointBatch, logits: torch.Tensor, diag) -> dict:
        result = {"seg_logits": logits, "feat": out.feat, "diagnostics": diag}
        if pb.segment is not None:
            result["loss"] = self.criteria(logits, pb.segment)
        return result


class _TextHead(nn.Module):
    """Cosine logits against text embeddings: ``proj_head``, the embedding
    table (``class_embedding``: a frozen buffer from `path`, else a trainable
    parameter made by `init_weights`) and ``logit_scale``."""

    def _text_init(self, in_channels: int, rows: int, dim: int, path: Optional[str]):
        if path and os.path.isfile(path):
            emb = np.load(path).astype(np.float32)
            if emb.shape[0] != rows:
                raise ValueError(f"{type(self).__name__}: {path} holds {emb.shape[0]} class embeddings, "
                                 f"the config names {rows} classes")
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            self.register_buffer("class_embedding", torch.from_numpy(emb))
            self.frozen_text = True
            dim = emb.shape[1]
        else:
            self.class_embedding = nn.Parameter(torch.empty(rows, dim))
            self.frozen_text = False
        self.proj_head = Linear(in_channels, dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def _text_logits(self, feat: torch.Tensor, rows) -> torch.Tensor:
        emb = self.class_embedding
        if not self.frozen_text:
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        emb = emb[rows]
        feat = self.proj_head(feat)
        # feat / max(|feat|, 1e-8), as the JAX package; a row of exact zeros
        # (every ReLU of a backbone off, a head bias at 0) gets zero logits and
        # no gradient, where JAX's gradient is NaN and the reference's logits are
        norm = torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        feat = feat * torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-8), 0.0)
        return torch.exp(self.logit_scale) * (feat @ emb.T)


@MODELS.register_module("PPT-v1m1")
class PointPromptTraining(_PromptBase, _TextHead):
    """Language-guided PPT (reference
    `point_prompt_training_v1m1_language_guided.py:19`). `forward(pb,
    generator, precomputed)` returns ``{"seg_logits", "feat",
    "diagnostics"}`` (and ``"loss"`` for a labelled batch); with
    `backbone_mode`, ``{"point", "feat", "diagnostics"}``. `template` and
    `clip_model` name the reference's text encoder, which the port does not
    run."""

    def __init__(self, backbone=None, criteria=None, backbone_out_channels: int = 96, context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"), template: str = "[x]",
                 clip_model: str = "ViT-B/16", class_name: Sequence[str] = DEFAULT_CLASS_NAMES,
                 valid_index: Sequence[Sequence[int]] = DEFAULT_VALID_INDEX, backbone_mode: bool = False,
                 class_embedding_path: Optional[str] = None, clip_embed_dim: int = 512):
        super().__init__(backbone, criteria, backbone_out_channels, conditions)
        if len(self.conditions) != len(valid_index):
            raise ValueError(f"PPT-v1m1: {len(self.conditions)} conditions but {len(valid_index)} valid_index lists")
        self.valid_index = [torch.as_tensor(v, dtype=torch.long) for v in valid_index]
        self.backbone_mode = backbone_mode
        self.embedding_table = nn.Embedding(len(self.conditions), context_channels)
        if not backbone_mode:
            self._text_init(self.feat_channels, len(class_name), clip_embed_dim, class_embedding_path)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                precomputed: Optional[dict] = None) -> dict:
        idx = _condition_index(self.conditions, pb.condition, "PPT-v1m1")
        with contextlib.nullcontext() if self.training else torch.no_grad():
            context = self.embedding_table(torch.tensor([idx], device=pb.device))
            pb = pb.replace(context=context)
            out, diag = self._backbone(pb, generator, precomputed)
            if self.backbone_mode:
                return {"point": out, "feat": out.feat, "diagnostics": diag}
            logits = self._text_logits(out.feat, self.valid_index[idx].to(pb.device))
            return self._result(pb, out, logits, diag)


@MODELS.register_module("PPT-v1m2")
class PointPromptTrainingDecoupled(_PromptBase):
    """Decoupled PPT (reference `point_prompt_training_v1m2_decoupled.py`):
    the context of v1m1 and one linear head a condition, ``seg_head{i}``."""

    def __init__(self, backbone=None, criteria=None, backbone_out_channels: int = 96, context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 num_classes: Sequence[int] = (25, 20, 13), backbone_mode: bool = False):
        super().__init__(backbone, criteria, backbone_out_channels, conditions)
        if len(self.conditions) != len(num_classes):
            raise ValueError(f"PPT-v1m2: {len(self.conditions)} conditions but {len(num_classes)} class counts")
        self.backbone_mode = backbone_mode
        self.embedding_table = nn.Embedding(len(self.conditions), context_channels)
        for i, n in enumerate(num_classes):
            self.add_module(f"seg_head{i}", Linear(self.feat_channels, n))

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                precomputed: Optional[dict] = None) -> dict:
        idx = _condition_index(self.conditions, pb.condition, "PPT-v1m2")
        with contextlib.nullcontext() if self.training else torch.no_grad():
            context = self.embedding_table(torch.tensor([idx], device=pb.device))
            pb = pb.replace(context=context)
            out, diag = self._backbone(pb, generator, precomputed)
            if self.backbone_mode:
                return {"point": out, "feat": out.feat, "diagnostics": diag}
            return self._result(pb, out, getattr(self, f"seg_head{idx}")(out.feat), diag)


@MODELS.register_module("PPT-v1m3")
class PointPromptTrainingNeo(_PromptBase, _TextHead):
    """PPT neo (reference `point_prompt_training_v1m3_neo.py:23`): one class
    list a condition (their text embeddings stacked in condition order), no
    context, the up-cast of every level of an ``enc_mode`` backbone, and
    ``freeze_backbone``. A batch with no condition raises (the configs'
    pipelines add none)."""

    def __init__(self, backbone=None, criteria=None, backbone_out_channels: int = 96,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"), template: str = "[x]",
                 clip_model: str = "ViT-B/16", class_names: Sequence[Sequence[str]] = DEFAULT_NEO_CLASS_NAMES,
                 freeze_backbone: bool = False, backbone_mode: bool = False,
                 class_embedding_path: Optional[str] = None, text_dim: int = 512):
        super().__init__(backbone, criteria, backbone_out_channels, conditions)
        if len(self.conditions) != len(class_names):
            raise ValueError(f"PPT-v1m3: {len(self.conditions)} conditions but {len(class_names)} class lists")
        counts = [len(c) for c in class_names]
        self.class_rows = [torch.arange(sum(counts[:i]), sum(counts[: i + 1])) for i in range(len(counts))]
        self.backbone_mode = backbone_mode
        self.freeze_backbone = freeze_backbone
        if freeze_backbone:
            self.backbone.requires_grad_(False)
        if not backbone_mode:
            self._text_init(self.feat_channels, sum(counts), text_dim, class_embedding_path)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                precomputed: Optional[dict] = None) -> dict:
        if pb.condition is None:
            raise ValueError(f"PPT-v1m3: the batch carries no condition (its pipeline needs an Add of one of "
                             f"{self.conditions})")
        idx = _condition_index(self.conditions, pb.condition, "PPT-v1m3")
        with contextlib.nullcontext() if self.training else torch.no_grad():
            out, diag = self._backbone(pb, generator, precomputed)
            if self.backbone_mode:
                return {"point": out, "feat": out.feat, "diagnostics": diag}
            logits = self._text_logits(out.feat, self.class_rows[idx].to(pb.device))
            return self._result(pb, out, logits, diag)
