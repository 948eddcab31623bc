"""Inference API: PoseEstimator, its configuration, the models and the
detection and pose collections."""

from .depth_refiner import DepthRefiner, ICPRefiner  # noqa: F401
from .load_model import NAMED_MODELS, load_named_model  # noqa: F401
from .pose_estimator import PoseEstimator  # noqa: F401
from .types import InferenceConfig, make_detections, make_pose_estimates  # noqa: F401
