"""Frame construction: ORB extraction + undistortion + normalized coords
(port of tpuslam/engine/frontend.py; ref: the Frame constructors,
src/Frame.cc:88/192/275).

Extraction, stereo matching and SAD refinement run on the frontend's
device; the host keeps numpy views in a FrameFeatures. The median-SAD
outlier filter here is np.median over the ok set (the mean of the two
middle values), as in tpuslam's frontend; the fused step takes
sorted[n // 2] instead, as tpuslam's step does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..map.store import FrameFeatures
from ..ops.orb import OrbExtractor
from ..ops.stereo import rgbd_to_stereo, sad_refine_pyramid, stereo_match
from ..utils import DEFAULT_DEVICE, resolve_device
from .config import OrbConfig


class Frontend:
    def __init__(self, camera, orb_cfg: OrbConfig, bf: float = 0.0,
                 device=DEFAULT_DEVICE):
        self.camera = camera
        self.device = resolve_device(device)
        self.extractor = OrbExtractor(orb_cfg, self.device)
        self.orb_cfg = orb_cfg
        self.bf = bf
        self.scale_factors = orb_cfg.scale ** np.arange(orb_cfg.n_levels)

    def _image(self, img):
        return torch.as_tensor(np.asarray(img), device=self.device).float()

    def process_stereo(self, img_l, img_r) -> FrameFeatures:
        """Stereo frame: extract both images, row-banded stereo match for
        per-feature depth (ref: stereo Frame ctor Frame.cc:88 +
        ComputeStereoMatches :802)."""
        im_l, im_r = self._image(img_l), self._image(img_r)
        out_l = self.extractor(im_l)
        out_r = self.extractor(im_r)
        f = self._features_from(out_l)
        dev = self.device
        xy_l = torch.as_tensor(f.xy, device=dev)
        oct_l = torch.as_tensor(f.octave, device=dev)
        u_r, _, ok = stereo_match(
            out_l["bits"], out_r["bits"], xy_l, out_r["xy"], oct_l, out_r["octave"],
            out_l["valid"], out_r["valid"],
            torch.as_tensor(self.scale_factors.astype(np.float32), device=dev),
            0.3, float(self.camera.fx))
        # SAD sub-pixel refinement + median-SAD outlier filter
        # (ref: Frame.cc:869-975 — thDist = 1.5 * 1.4 * median)
        u_r, sad, ok = sad_refine_pyramid(
            im_l, im_r, xy_l, oct_l, u_r, ok,
            n_levels=self.orb_cfg.n_levels, scale=float(self.orb_cfg.scale))
        okn = ok.cpu().numpy()
        sadn = sad.cpu().numpy()
        if okn.any():
            th = 1.5 * 1.4 * np.median(sadn[okn])
            okn = okn & (sadn < th)
        u_rn = u_r.cpu().numpy()
        disp = f.xy[:, 0] - u_rn
        okn = okn & (disp > 1e-3)
        # depth_from_disparity (tpuslam/ops/stereo.py), in f32 as there
        z = np.where(disp > 1e-3, np.float32(self.bf) / np.maximum(disp, np.float32(1e-3)),
                     np.float32(-1.0))
        f.depth = np.where(okn, z, -1.0)
        f.u_right = np.where(okn, u_rn, -1.0)
        return f

    def process_rgbd(self, img, depth_map, depth_factor: float = 1.0) -> FrameFeatures:
        """RGB-D frame (ref: RGB-D Frame ctor Frame.cc:192 +
        ComputeStereoFromRGBD :983): per-feature depth from the depth map
        and a virtual right coordinate from bf."""
        f = self.process(img)
        z, u_r = rgbd_to_stereo(f.xy, np.asarray(depth_map), self.bf, depth_factor)
        f.depth = np.where(z > 0, z, -1.0)
        f.u_right = np.where(z > 0, u_r, -1.0)
        return f

    def process(self, img) -> FrameFeatures:
        """Monocular frame (ref: monocular Frame ctor Frame.cc:275)."""
        return self._features_from(self.extractor(self._image(img)))

    def _features_from(self, out) -> FrameFeatures:
        xy = out["xy"]
        und = self.camera.undistort_points(xy)
        norm = self.camera.unproject(und)[..., :2]

        def host(t):
            return t.cpu().numpy()

        return FrameFeatures(
            xy=host(xy), und_xy=host(und), norm_xy=host(norm), octave=host(out["octave"]),
            angle=host(out["angle"]), response=host(out["resp"]), bits=host(out["bits"]),
            packed=host(out["packed"]), valid=host(out["valid"]))
