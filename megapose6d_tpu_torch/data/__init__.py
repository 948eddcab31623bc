"""Observation and collection types, and the training batch loader."""

from .loader import ParallelBatchLoader, PoseBatchFactory  # noqa: F401
from .tensor_collection import TensorCollection, concatenate  # noqa: F401
from .types import (  # noqa: F401
    CameraData,
    ObjectData,
    ObservationTensor,
    object_data_from_json_path,
    object_data_to_json_path,
)
