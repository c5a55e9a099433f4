"""Frame construction: ORB extraction + undistortion + normalized coords
(port of tpuslam/engine/frontend.py; ref: the Frame constructors,
src/Frame.cc:88/192/275, and the fisheye stereo one, :1034).

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
from ..ops import match as M
from ..ops.orb import OrbExtractor
from ..ops.stereo import rgbd_to_stereo, sad_refine_pyramid, stereo_match
from ..ops.twoview import triangulate_batch
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

    def process_stereo_fisheye(self, img_l, img_r, camera_r, R_rl, t_rl) -> FrameFeatures:
        """Fisheye (KB8) stereo frame: brute-force ratio-0.7 matching inside
        both lapping areas and two-ray triangulation for per-feature depth
        (ref: ComputeStereoFishEyeMatches Frame.cc:1128 and
        KannalaBrandt8::TriangulateMatches KannalaBrandt8.cpp:334 with its
        cheirality, reprojection and parallax gates).

        R_rl, t_rl: the right-from-left extrinsic. u_right carries the
        scaled inverse depth bf/z, the third residual row of KB8 stereo
        observations (solve/reproj.py)."""
        f = self.process(img_l)
        out_r = self._extract_raw(img_r)
        xy_r = out_r["xy"].cpu().numpy()
        valid_r = out_r["valid"].cpu().numpy()
        bits_r = out_r["bits"].cpu().numpy()
        lap_l = getattr(self.camera, "lapping", (0, self.camera.width))
        lap_r = getattr(camera_r, "lapping", (0, camera_r.width))
        in_lap_l = (f.xy[:, 0] >= lap_l[0]) & (f.xy[:, 0] <= lap_l[1])
        in_lap_r = (xy_r[:, 0] >= lap_r[0]) & (xy_r[:, 0] <= lap_r[1])
        mask = (f.valid & in_lap_l)[:, None] & (valid_r & in_lap_r)[None, :]
        midx, _ = M.match_padded(f.bits, bits_r, mask, max_dist=M.TH_HIGH, nn_ratio=0.7,
                                 device=self.device)
        il = np.nonzero(midx >= 0)[0]
        depth = np.full(f.n, -1.0)
        if len(il):
            ir = midx[il]
            R_rl = np.asarray(R_rl, np.float64)
            t_rl = np.asarray(t_rl, np.float64)
            rays_r = camera_r.unproject(torch.as_tensor(xy_r[ir], device=self.device))
            rays_r = rays_r.cpu().numpy()
            x2 = rays_r[:, :2] / np.maximum(rays_r[:, 2:3], 1e-9)

            def f64(a):
                return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

            # the rays are f32 (as extracted); the triangulation runs in f64
            X = triangulate_batch(f64(np.eye(3)), f64(np.zeros(3)), f64(R_rl), f64(t_rl),
                                  f64(f.norm_xy[il]), f64(x2)).cpu().numpy()
            Xr = X @ R_rl.T + t_rl
            # gates (ref TriangulateMatches): cheirality, reprojection in
            # both cameras, parallax
            e_l = np.sum((self.camera.project_np(X) - f.und_xy[il]) ** 2, 1)
            e_r = np.sum((camera_r.project_np(Xr) - xy_r[ir]) ** 2, 1)
            r1 = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
            v2 = X - (-R_rl.T @ t_rl)[None]
            v2 = v2 / np.maximum(np.linalg.norm(v2, axis=1, keepdims=True), 1e-9)
            cosp = np.sum(r1 * v2, 1)
            # the parallax gate is set for a short stereo baseline: it only
            # rejects near-degenerate rays
            ok = (X[:, 2] > 0.05) & (Xr[:, 2] > 0.05) & (e_l < 5.991) & (e_r < 5.991) \
                & (cosp < 0.99998)
            depth[il[ok]] = X[ok, 2]
        f.depth = depth
        # features are stereo only with a calibrated bf: with bf == 0 every
        # depth would give a degenerate zero third residual row
        f.u_right = np.where((depth > 0) & (self.bf > 0), self.bf / np.maximum(depth, 1e-6),
                             -1.0)
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
        return self._features_from(self._extract_raw(img))

    def _extract_raw(self, img):
        """The extractor's tensors of one image (keypoints, descriptors)."""
        return self.extractor(self._image(img))

    def _features_from(self, out) -> FrameFeatures:
        xy = out["xy"]
        # a fisheye camera has no undistortion step: unproject inverts its
        # whole model
        und = self.camera.undistort_points(xy) if hasattr(self.camera, "undistort_points") \
            else xy
        norm = self.camera.unproject(und)[..., :2]

        def host(t):
            return t.cpu().numpy()

        return FrameFeatures(
            xy=host(xy), und_xy=host(und), norm_xy=host(norm), octave=host(out["octave"]),
            angle=host(out["angle"]), response=host(out["resp"]), bits=host(out["bits"]),
            packed=host(out["packed"]), valid=host(out["valid"]))
