"""Offline map and frame drawings (port of tpuslam/viz.py).

Replaces the live Pangolin viewer (src/Viewer.cc, MapDrawer.cc:43
DrawMapPoints / :82 DrawKeyFrames / the covisibility graph, FrameDrawer.cc:37
keypoint overlays) with matplotlib figures written to PNG. The map is host
state already; a frame's image, features and map-point ids may be tensors
on the card and are moved to host numpy first. matplotlib is imported
inside each function, so the module imports where matplotlib is missing
(as on the card host) and only drawing needs it.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    """A tensor (on any device) or array-like as a host numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_map(m, path: str, trajectory=None, gt=None, elev=35, azim=-60):
    """Top and 3D view of the map points (black), keyframes (blue),
    covisibility edges (green), trajectory (red) and ground truth (orange,
    dashed): the MapDrawer colour scheme."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 6))
    ax3 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)
    pts = m.mp_pos[: m.n_mp][m.mp_valid[: m.n_mp]]
    kfs = m.valid_kf_ids(all_maps=True)
    centers = np.stack([m.kf_center(k) for k in kfs]) if len(kfs) else None
    for ax, dims in ((ax3, (0, 1, 2)), (ax2, (0, 1))):
        if len(pts):
            ax.scatter(*[pts[:, d] for d in dims], s=1, c="k", alpha=0.3)
        if centers is not None:
            ax.scatter(*[centers[:, d] for d in dims], s=12, c="tab:blue")
            for k in kfs:  # the covisibility graph
                ck = m.kf_center(k)
                for o, w in m.covis[k].items():
                    if o < k or not m.kf_valid[o] or w < 30:
                        continue
                    seg = np.stack([ck, m.kf_center(o)])
                    ax.plot(*[seg[:, d] for d in dims], c="g", lw=0.4, alpha=0.5)
        if trajectory is not None and len(trajectory):
            tr = _host(trajectory)
            ax.plot(*[tr[:, d] for d in dims], c="r", lw=1.0)
        if gt is not None and len(gt):
            g = _host(gt)
            ax.plot(*[g[:, d] for d in dims], c="orange", lw=1.0, ls="--")
    ax3.view_init(elev=elev, azim=azim)
    ax2.set_aspect("equal")
    ax2.set_xlabel("x")
    ax2.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_frame(img, feats, mp_ids, path: str):
    """A frame with keypoint overlays: tracked map points green, untracked
    detections red (ref FrameDrawer::DrawFrame)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(_host(img), cmap="gray")
    valid = _host(feats.valid)
    xy = _host(feats.xy)[valid]
    tracked = (_host(mp_ids) >= 0)[valid] if mp_ids is not None else np.zeros(len(xy), bool)
    ax.scatter(xy[~tracked, 0], xy[~tracked, 1], s=6, facecolors="none", edgecolors="r",
               lw=0.6)
    ax.scatter(xy[tracked, 0], xy[tracked, 1], s=8, facecolors="none", edgecolors="lime",
               lw=0.8)
    ax.set_title(f"{int(tracked.sum())} tracked / {len(xy)} keypoints")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
