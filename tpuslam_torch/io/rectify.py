"""Stereo rectification: undistort-rectify maps + bilinear remap (port of
tpuslam/io/rectify.py).

Replaces the reference stereo drivers' cv::initUndistortRectifyMap +
cv::remap stage (ref: Examples/Stereo-Inertial/stereo_inertial_euroc.cc:
92-96 builds M1l/M2l/M1r/M2r from the LEFT./RIGHT. {K,D,R,P} YAML blocks
parsed at src/Tracking.cc:274-295, then remaps every frame).

The maps are built once on the host (numpy, as in tpuslam) and kept on
the rectifier's device; the per-frame remap is four gathers there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import DEFAULT_DEVICE, resolve_device


def build_rectify_map(K, D, R, P, height: int, width: int):
    """Source-pixel lookup map for a rectified image, matching
    cv2.initUndistortRectifyMap semantics: for every rectified pixel,
    project its ray back through R^-1, re-apply the radial-tangential
    distortion D = (k1, k2, p1, p2[, k3]), and map through the RAW
    intrinsics K. Returns (map_x, map_y) float32 [H, W]."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    fxp, fyp = P[0, 0], P[1, 1]
    cxp, cyp = P[0, 2], P[1, 2]
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    x = (u - cxp) / fxp
    y = (v - cyp) / fyp
    ones = np.ones_like(x)
    ray = np.stack([x, y, ones], -1) @ np.linalg.inv(R).T
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """Bilinear sample img [H, W] at (map_x, map_y) (f32 tensors on img's
    device); out-of-bounds -> 0 (cv2.remap BORDER_CONSTANT)."""
    H, W = img.shape
    flat = img.float().reshape(-1)
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    ax = map_x - x0
    ay = map_y - y0
    x0i = x0.long()
    y0i = y0.long()
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)

    def at(yi, xi):
        return flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]

    val = (
        at(y0i, x0i) * (1 - ax) * (1 - ay)
        + at(y0i, x0i + 1) * ax * (1 - ay)
        + at(y0i + 1, x0i) * (1 - ax) * ay
        + at(y0i + 1, x0i + 1) * ax * ay
    )
    return torch.where(inb, val, 0.0)


class StereoRectifier:
    """Holds the four maps on `device`; __call__ rectifies an (img_l,
    img_r) pair there and returns the host arrays tpuslam's returns (the
    tracker takes host images)."""

    def __init__(self, left: dict, right: dict, height: int, width: int,
                 device=DEFAULT_DEVICE):
        """left/right: dicts with K, D, R, P (the YAML LEFT./RIGHT. blocks;
        per-side height/width may override the output size)."""
        self.device = resolve_device(device)
        self.maps_l, self.maps_r = (
            tuple(torch.as_tensor(m, device=self.device)
                  for m in build_rectify_map(s["K"], s["D"], s["R"], s["P"], height, width))
            for s in (left, right))

    def rectify(self, img_l, img_r):
        """The rectified pair as f32 tensors on the rectifier's device."""
        return tuple(remap_bilinear(torch.as_tensor(np.asarray(im), device=self.device), *m)
                     for im, m in ((img_l, self.maps_l), (img_r, self.maps_r)))

    def __call__(self, img_l, img_r):
        out_l, out_r = self.rectify(img_l, img_r)
        return out_l.cpu().numpy(), out_r.cpu().numpy()
