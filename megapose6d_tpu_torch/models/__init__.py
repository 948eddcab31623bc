"""Networks: the ResNet backbone and the coarse/refiner PosePredictor."""

from .backbones import ResNet, WideResNet, make_backbone  # noqa: F401
from .pose_predictor import (  # noqa: F401
    PosePredictor,
    PosePredictorConfig,
    make_coarse_config,
    make_refiner_config,
)
