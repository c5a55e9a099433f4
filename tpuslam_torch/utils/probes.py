"""What a run of the port is observed by, shared by chip_smoke.py and the
port's scripts: the card's nvidia-smi line, the ground-truth camera centres
of trajectory rows, and the kernels' launch counters beside the tracker's
visual-inertial stage counts."""

import subprocess

import numpy as np


def nvidia_smi_line():
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def gt_centers(seq, traj):
    """Ground-truth camera centres of a sequence at the stamps of
    trajectory rows (t, x, y, z, ...)."""
    return np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])


def vi_counts():
    """Kernel launches, then the tracker's timed stages: one "pose_inertial"
    sample per pose-inertial solve (plain torch), the fused VI step and the
    host path."""
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    return (patch_cuda.counter.launches, pose_opt_cuda.counter.launches,
            *(len(GLOBAL_TIMER.samples.get(s, []))
              for s in ("pose_inertial", "track_fused_vi", "track")))
