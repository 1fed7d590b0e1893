from .builder import MODELS, apply_amp_policy, build_model
from . import default  # noqa: F401  (registers DefaultSegmentor, DefaultSegmentorV2)
from .context_aware_classifier import CACSegmentor  # noqa: F401  (registers CAC-v1m1)
from .litept import LitePT  # noqa: F401  (registers LitePT-v1)
from .point_group import PointGroup  # noqa: F401  (registers PG-v1m1/m2)
from .point_prompt_training import PointPromptTraining  # noqa: F401  (registers PPT-v1m1/m2/m3)
from .point_transformer_v2 import PointTransformerV2  # noqa: F401  (registers PT-v2m1/m2/m3)
from .point_transformer_v3 import PointTransformerV3  # noqa: F401  (registers PT-v3m1/m2)
from .sonata import Sonata  # noqa: F401  (registers Sonata-v1m1)
from .sparse_unet import SpUNetBase  # noqa: F401  (registers SpUNet-v1m1/m2, MinkUNet*)

__all__ = ["MODELS", "apply_amp_policy", "build_model", "CACSegmentor", "LitePT", "PointGroup", "PointPromptTraining",
           "PointTransformerV2", "PointTransformerV3", "Sonata", "SpUNetBase"]
