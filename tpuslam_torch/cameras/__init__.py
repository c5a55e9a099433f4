from .base import CameraModel  # noqa: F401
from .kb8 import KannalaBrandt8  # noqa: F401
from .pinhole import Pinhole  # noqa: F401

