from .base import CameraModel  # noqa: F401
from .kb8 import KannalaBrandt8  # noqa: F401
from .pinhole import Pinhole  # noqa: F401


def make_camera(kind: str, params, width: int, height: int):
    """Camera model by its settings-file name (tpuslam/cameras/__init__.py)."""
    kind_l = kind.lower()
    if kind_l in ("pinhole", "pin_hole"):
        return Pinhole(params, width, height)
    if kind_l in ("kannalabrandt8", "kb8", "fisheye"):
        return KannalaBrandt8(params, width, height)
    raise ValueError(f"unknown camera type {kind}")
