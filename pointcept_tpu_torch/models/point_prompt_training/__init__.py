from .point_prompt_training import (  # noqa: F401  (registers PPT-v1m1, PPT-v1m2, PPT-v1m3)
    PointPromptTraining, PointPromptTrainingDecoupled, PointPromptTrainingNeo,
)
