"""Camera model interface (port of tpuslam/cameras/base.py).

The class carries static calibration; project/unproject are batched
functions over torch tensors, project_np the host (numpy) form.
"""

from __future__ import annotations

import numpy as np


class CameraModel:
    """Base: subclasses implement project / project_np / unproject /
    project_jac."""

    kind = "base"

    def __init__(self, params, width: int, height: int):
        self.params = np.asarray(params, dtype=np.float32)
        self.width = int(width)
        self.height = int(height)

    # fx, fy, cx, cy are always the first four parameters
    @property
    def fx(self):
        return float(self.params[0])

    @property
    def fy(self):
        return float(self.params[1])

    @property
    def cx(self):
        return float(self.params[2])

    @property
    def cy(self):
        return float(self.params[3])

    def K(self):
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float32
        )

    @property
    def spec(self):
        """Static CamSpec for the optimization residuals (solve/reproj.py);
        pinhole solvers take their intrinsics through the fx..bf scalars."""
        from ..solve.reproj import PINHOLE

        return PINHOLE

    def project(self, Xc):
        """[...,3] camera-frame points -> [...,2] pixels."""
        raise NotImplementedError

    def project_np(self, Xc):
        """Host (numpy) projection."""
        raise NotImplementedError

    def unproject(self, uv):
        """[...,2] pixels -> [...,3] unit-depth rays (z=1 normalized)."""
        raise NotImplementedError

    def project_jac(self, Xc):
        """d(uv)/d(Xc): [...,2,3]."""
        raise NotImplementedError
