"""S3DIS (counterpart of `pointcept_tpu/datasets/s3dis.py`; parity target:
reference `pointcept/datasets/s3dis.py`): preprocessed .npy rooms under
``data_root/Area_k/<room>/``; the split is an area or a tuple of areas
(``("Area_1", "Area_2", ...)``), read in order by `DefaultDataset`."""

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class S3DISDataset(DefaultDataset):
    pass
