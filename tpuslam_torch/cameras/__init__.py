from .base import CameraModel  # noqa: F401
from .pinhole import Pinhole  # noqa: F401
