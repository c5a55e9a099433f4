"""The fisheye (Kannala-Brandt 8) stereo rig of the fisheye tests, at any size.

`KB_L`, `KB_R` are tests/test_e2e_fisheye.py's 256x256 pair: an
equidistant base model with TUM-VI's k1-k4, lapping over the whole width.
`kb8_rig(size)` scales fx, fy, cx, cy by size / 256 and keeps the k's: at
512 it is chip_smoke.py's TUM-VI-sized rig, whose focal length (190) is
within 0.5 % of TUM_512.yaml's (190.98). The right camera sits `baseline`
to the right of the left one (Trl = right-from-left).

Both the port's tests and chip_smoke.py import this module (chip_smoke.py
puts tests/ on sys.path), so it imports only the port and numpy.
"""

import numpy as np

from tpuslam_torch.cameras import KannalaBrandt8

KB_L = [95.0, 95.0, 128.0, 128.0, 0.0034823894, 0.00071503485, -0.0020532361, 0.00020293674]
KB_R = [94.8, 94.9, 127.6, 128.3, 0.0034003171, 0.0017662782, -0.0026631257, 0.00032995174]
BASELINE = 0.2   # m


def kb8_rig(size=256, baseline=BASELINE):
    """(left camera, right camera, Trl) of the rig at size x size."""
    lap = (0, size - 1)
    cam, cam2 = (KannalaBrandt8([v * size / 256 for v in p[:4]] + p[4:], size, size,
                                lapping=lap)
                 for p in (KB_L, KB_R))
    Trl = np.eye(4)
    Trl[0, 3] = -baseline
    return cam, cam2, Trl
