"""Host-side helpers: logging, timers, image codecs, the OCDBT store."""

from .logging import get_logger  # noqa: F401
from .timers import DeviceTimer, Timer  # noqa: F401
