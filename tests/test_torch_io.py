"""The port's IO layer against tpuslam's, on the CPU.

  * load_settings on inline YAMLs in the reference's format (EuRoC mono
    with Tbc, EuRoC stereo with LEFT./RIGHT., TUM-VI 512 fisheye with
    Camera2.* / Tlr / lapping, TUM RGB-D with DepthMapFactor, KITTI):
    every field equal, `raw` equal to what tpuslam's PyYAML loader gives,
    in value and in type; the scalar resolution of the port's own
    OpenCV-YAML reader against PyYAML's, and the constructs it refuses.
  * The PNG reader bitwise equal to cv2.imread (GRAYSCALE and UNCHANGED)
    on 8- and 16-bit gray, RGB and RGBA files written with each row
    filter; the native unfilter equal to its numpy reference; interlaced
    files and bit depths below 8 refused.
  * All five loaders (EuRoC, TUM-VI, KITTI, TUM RGB-D, CSV) on trees
    written here: times, paths, IMU, ground truth, images and depth equal.
  * build_rectify_map bitwise, remap_bilinear within 1e-4 gray levels of
    tpuslam's, and the rectifier's identity maps.
  * ORBvoc text / binary and npz vocabularies: the files the port writes
    are tpuslam's bytes, and both loaders give the same tree, on a trained
    and on an irregular tree.
  * The map checkpoint: the npz keys and dtypes of tpuslam's, the round
    trip, and no torch tensor in its blob.
"""

import math
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml

from tpuslam.io import datasets as j_datasets
from tpuslam.io import rectify as j_rectify
from tpuslam.io.settings import _strip_opencv_header
from tpuslam.io.settings import load_settings as j_load_settings
from tpuslam.map import checkpoint as j_checkpoint
from tpuslam.map.store import FrameFeatures as JFrameFeatures
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.place import orbvoc as j_orbvoc
from tpuslam.place import store as j_store
from tpuslam.place import train_vocabulary as j_train_vocabulary
from tpuslam_torch import native
from tpuslam_torch.io import datasets, png, rectify
from tpuslam_torch.io.settings import load_settings, parse_opencv_yaml
from tpuslam_torch.map import checkpoint
from tpuslam_torch.map.store import FrameFeatures, SlamMap
from tpuslam_torch.place import load_orbvoc, save_orbvoc_binary, save_orbvoc_text
from tpuslam_torch.place import store
from tpuslam_torch.place.vocab import vocab_from_numpy

torch.set_num_threads(2)

# ---------------------------------------------------------------- settings
EUROC_MONO_IMU = """%YAML:1.0

#--------------------------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------------------------
Camera.type: "PinHole"

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375

Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05

# Camera resolution
Camera.width: 752
Camera.height: 480

# Camera frames per second
Camera.fps: 20.0

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Transformation from camera to body-frame (imu)
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# IMU noise
IMU.NoiseGyro: 1.7e-04 #1.6968e-04
IMU.NoiseAcc: 2e-3 # no dot: PyYAML keeps this a string
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0000e-03 # 3e-03
IMU.Frequency: 200

#--------------------------------------------------------------------------------------------
# ORB Parameters
#--------------------------------------------------------------------------------------------
ORBextractor.nFeatures: 1000 # Tested with 1250
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.ViewpointF: 500
Viewer.on: yes
"""

EUROC_STEREO = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
Camera.RGB: 1
ThDepth: 35

#--------------------------------------------------------------------------------------------
# Stereo Rectification. Only if you need to pre-rectify the images.
#--------------------------------------------------------------------------------------------
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]

RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
          0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
          -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]

ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

TUM_512 = """%YAML:1.0
---
Camera.type: "KannalaBrandt8"
Camera.fx: 190.97847715128717
Camera.fy: 190.9733070521226
Camera.cx: 254.93170605935475
Camera.cy: 256.8974428996504
Camera.k1: 0.0034823894022493434
Camera.k2: 0.0007150348452162257
Camera.k3: -0.0020532361418706202
Camera.k4: 0.00020293673591811182

Camera2.fx: 190.44236969414825
Camera2.fy: 190.4344384721956
Camera2.cx: 252.59949716835982
Camera2.cy: 254.91723064636983
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039

Tlr: !!opencv-matrix
  rows: 3
  cols: 4
  dt: f
  data: [ 0.999999445773493,   0.000791687752817,   0.000694034010224,   0.101063427414194,
         -0.000823363992158,   0.998899461915674,   0.046895490788700,   0.001946204678584,
         -0.000656143613644,  -0.046896036240590,   0.998899560146198,   0.001015350132563]

# Lapping area between images
Camera.lappingBegin: 0
Camera.lappingEnd: 511
Camera2.lappingBegin: 0
Camera2.lappingEnd: 511

Camera.width: 512
Camera.height: 512
Camera.fps: 20.0
Camera.bf: 19.3079
Camera.RGB: 1
ThDepth: 40.0

IMU.NoiseGyro: 0.00016 # 0.004 (VINS) # 0.00016 (TUM) # 0.00016    # rad/s^0.5
IMU.NoiseAcc: 0.0028 # 0.04 (VINS) # 0.0028 (TUM) # 0.0028     # m/s^1.5
IMU.GyroWalk: 0.000022 # 0.000022 (VINS and TUM) rad/s^1.5
IMU.AccWalk: 0.00086 # 0.0004 (VINS) # 0.00086 # 0.00086    # m/s^2.5
IMU.Frequency: 200

ORBextractor.nFeatures: 1000 # Tested with 1250
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

TUM_RGBD = """%YAML:1.0
Camera.type: 'PinHole'
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
# Deptmap values factor
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

KITTI = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.PointSize: 2
"""

YAMLS = {"euroc_mono_imu": EUROC_MONO_IMU, "euroc_stereo": EUROC_STEREO,
         "tum_512": TUM_512, "tum_rgbd": TUM_RGBD, "kitti": KITTI}


class _CvLoader(yaml.SafeLoader):
    pass


_CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix",
                          lambda loader, node: loader.construct_mapping(node, deep=True))


def _pyyaml(text):
    """What tpuslam's load_settings parses (tpuslam/io/settings.py:71-81)."""
    return yaml.load(_strip_opencv_header(text), Loader=_CvLoader)


def _same(a, b):
    """Equal in value and type, recursively (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _camera_fields(cam):
    if cam is None:
        return None
    return dict(cls=type(cam).__name__, kind=cam.kind, params=cam.params, w=cam.width,
                h=cam.height, dist=getattr(cam, "dist", None), k=getattr(cam, "k", None),
                lapping=getattr(cam, "lapping", None))


@pytest.mark.parametrize("name", list(YAMLS))
def test_load_settings_matches_tpuslam(name, tmp_path):
    p = tmp_path / f"{name}.yaml"
    p.write_text(YAMLS[name])
    got, want = load_settings(str(p)), j_load_settings(str(p))
    assert _same(got.raw, want.raw), (got.raw, want.raw)
    for a, b in ((got.camera, want.camera), (got.camera2, want.camera2)):
        fa, fb = _camera_fields(a), _camera_fields(b)
        assert (fa is None) == (fb is None)
        if fa is not None:
            for k in fa:
                assert _same_array(fa[k], fb[k]) if k in ("params", "dist", "k") else fa[k] == fb[k], k
    o, jo = got.cfg.orb, want.cfg.orb
    for k in ("n_features", "scale", "n_levels", "ini_th", "min_th"):
        assert getattr(o, k) == getattr(jo, k), k
    assert got.cfg.th_depth == want.cfg.th_depth
    # the port keeps 1 / DepthMapFactor, which its tracker applies once to the raw
    # depth image; tpuslam keeps DepthMapFactor and applies it twice (ROADMAP §3)
    assert got.cfg.depth_map_factor == 1.0 / want.cfg.depth_map_factor
    assert got.cfg.tracking.max_frames_between_kf == want.cfg.tracking.max_frames_between_kf
    assert (got.bf, got.fps, got.has_imu) == (want.bf, want.fps, want.has_imu)
    assert _same_array(got.Tbc, want.Tbc) and _same_array(got.Tlr, want.Tlr)
    if want.imu_calib is not None:
        for k in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "freq"):
            assert getattr(got.imu_calib, k) == getattr(want.imu_calib, k), k
        assert _same_array(got.imu_calib.Tbc, want.imu_calib.Tbc)
    assert (got.rectification is None) == (want.rectification is None)
    if want.rectification is not None:
        r, jr = got.rectification, want.rectification
        assert (r["height"], r["width"]) == (jr["height"], jr["width"])
        for side in ("left", "right"):
            for k in "KDRP":
                assert _same_array(r[side][k], jr[side][k]), (side, k)
    # what each file exercises
    if name == "euroc_mono_imu":
        assert got.raw["IMU.NoiseAcc"] == "2e-3" and got.imu_calib.noise_acc == 2e-3
        assert got.raw["IMU.NoiseGyro"] == 1.7e-4 and got.raw["Viewer.on"] is True
    if name == "tum_512":
        assert got.camera.kind == got.camera2.kind == "kb8" and got.camera.lapping == (0, 511)
        assert got.Tlr.shape == (4, 4) and got.Tlr[3, 3] == 1.0
    if name == "tum_rgbd":
        assert got.cfg.depth_map_factor == 1.0 / 5000.0 and got.camera.dist[4] != 0


SCALARS = """a: 1
b: 2e-3
c: 1.7e-4
d: 1.0e5
e: yes
f: Off
g: "quoted 1.5"
h: 'it''s'
i: plain text # trailing
j: 0x1F
k: 017
l: 1:30
m: 1_000
n: .inf
o: -.INF
p: ~
q:
r: null
s: 3.
t: .5
u: -0
v: +12
w: "esc \\t \\x41 \\u00e9 \\\\"
x: a#b
y: [1, 2.5, 3e-3, "q", yes, 'x, y', ]
z: [ ]
aa: [1,
     2, # a comment inside the list
     3]
nested:
   x: 1
   y:
      z: "deep"
   w: 2
after: 1.5e+3
1: one
"Quoted.key": 5
dup: 1
dup: 2
sex: 190:20:30.15
neg: -1.5
bin: 0b101
nan: .NaN
url: http://a.b/c
"""


def test_yaml_reader_resolves_scalars_as_pyyaml():
    got, want = parse_opencv_yaml("%YAML:1.0\n---\n" + SCALARS), _pyyaml("%YAML:1.0\n" + SCALARS)
    assert _same(got, want), {k: (got.get(k), want[k]) for k in want
                              if not _same(got.get(k), want[k])}
    assert got["b"] == "2e-3" and got["d"] == "1.0e5" and got["c"] == 1.7e-4
    assert got["e"] is True and got["f"] is False and got["g"] == "quoted 1.5"


@pytest.mark.parametrize("text", ["a: [1, 2", "a: - x", "a: |\n  x", "a: &x 1", "a: 2020-01-01",
                                  "a: b: c", "a: 1\n  b: 2", "- 1", "a: !!str x", 'a: "open',
                                  "Tbc: !!opencv-matrix\nb: 1", "a: {b: 1}"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_opencv_yaml(text)


# --------------------------------------------------------------------- PNG
def _image(dtype, channels, seed=0, h=23, w=37):
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    # a smooth ramp plus noise: every filter sees real neighbours
    base = (np.add.outer(np.arange(h), np.arange(w))[..., None] * 7
            + np.arange(channels) * 50) % (top + 1)
    img = (base + rng.randint(0, 40, (h, w, channels))) % (top + 1)
    img = img.astype(dtype)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint16, 1), (np.uint8, 3),
                                            (np.uint8, 4), (np.uint16, 3)])
def test_png_reader_matches_cv2(tmp_path, dtype, channels, filters):
    img = _image(dtype, channels)
    fts = list(np.random.RandomState(1).randint(0, 5, img.shape[0])) if filters == "mixed" \
        else filters
    p = str(tmp_path / "x.png")
    png.write_png(p, img, fts)
    gray, ref = png.read_png(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    assert gray.dtype == ref.dtype == np.uint8 and gray.shape == ref.shape
    assert np.array_equal(gray, ref)
    raw, ref = png.read_png(p, gray=False), cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert raw.dtype == ref.dtype and np.array_equal(raw, ref)
    # the samples themselves: cv2 gives colour as BGR(A)
    want = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
    assert np.array_equal(raw, want)
    if channels >= 3:   # RGB -> gray within one level of BT.601
        rgb = img[..., :3].astype(np.float64) / (257.0 if dtype == np.uint16 else 1.0)
        y = rgb @ [0.299, 0.587, 0.114]
        assert np.abs(gray - y).max() <= 1.0


@pytest.mark.parametrize("what", ["cv2_written_gray", "cv2_written_rgb"])
def test_png_reader_reads_files_cv2_wrote(tmp_path, what):
    """cv2's writer chooses its own (adaptive) row filters."""
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:120, 0:160]
    img = (np.sin(xx / 9.0) * 60 + np.cos(yy / 7.0) * 50 + 128 + rng.randn(120, 160) * 3)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if what == "cv2_written_rgb":
        img = np.stack([img, np.roll(img, 5, 1), 255 - img], -1)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, img)
    assert np.array_equal(png.read_png(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    assert np.array_equal(png.read_png(p, gray=False), cv2.imread(p, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    rng = np.random.RandomState(bpp)
    h, stride = 31, 17 * bpp
    rows = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    rows[:, 0] = rng.randint(0, 5, h)
    raw = rows.tobytes()
    assert native.available()
    got = native.png_unfilter(raw, h, stride, bpp)
    assert got.dtype == np.uint8 and np.array_equal(got, png.unfilter_plain(raw, h, stride, bpp))
    rows[7, 0] = 5
    for fn in (native.png_unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="row 7"):
            fn(rows.tobytes(), h, stride, bpp)
    with pytest.raises(ValueError, match="rows of"):       # sizes checked before the call
        native.png_unfilter(raw[:-1], h, stride, bpp)


def _png_bytes(w, h, depth, ctype, interlace, data):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                        interlace))
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["interlaced", "depth_4", "depth_1", "bad_crc", "missing"])
def test_png_reader_refuses_what_it_does_not_decode(tmp_path, case):
    p = str(tmp_path / "r.png")
    if case == "interlaced":
        data = _png_bytes(4, 4, 8, 0, 1, b"\0" * 40)
    elif case.startswith("depth"):
        data = _png_bytes(8, 2, int(case[-1]), 0, 0, b"\0" * 10)
    else:
        data = bytearray(_png_bytes(4, 2, 8, 0, 0, b"\0\1\2\3\4" * 2))
        data[20] ^= 1
    if case == "missing":
        with pytest.raises(FileNotFoundError):
            png.read_png(p)
        return
    with open(p, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(ValueError, match={"interlaced": "interlaced", "bad_crc": "corrupt"}.get(
            case, "bit depth")):
        png.read_png(p)


# ----------------------------------------------------------------- loaders
T0 = 1403636579763555584


def _write_euroc(root, n=4, h=48, w=64):
    rng = np.random.RandomState(0)
    mav = root / "mav0"
    for cam in ("cam0", "cam1"):
        (mav / cam / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i in range(n):
            ns = T0 + i * 50_000_000
            cv2.imwrite(str(mav / cam / "data" / f"{ns}.png"),
                        (rng.rand(h, w) * 255).astype(np.uint8))
            rows.append(f"{ns},{ns}.png")
        if cam == "cam1":
            rows = rows[:-1]           # one image fewer: the loader trims to both
        (mav / cam / "data.csv").write_text("\n".join(rows) + "\n")
    (mav / "imu0").mkdir()
    imu = ["#timestamp,w_x,w_y,w_z,a_x,a_y,a_z"]
    for i in range(n * 10):
        ns = T0 - 25_000_000 + i * 5_000_000
        imu.append(f"{ns},{0.01 * i},-0.02,0.03,0.1,0.2,9.7")
    (mav / "imu0" / "data.csv").write_text("\n".join(imu) + "\n")
    (mav / "state_groundtruth_estimate0").mkdir()
    gt = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z"]
    for i in range(n * 4):
        ns = T0 + i * 12_500_000
        gt.append(f"{ns},{0.1 * i},0.2,0.3,0.9,0.1,{0.01 * i},0.3")
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text("\n".join(gt) + "\n")


def _write_kitti(root, n=3):
    rng = np.random.RandomState(1)
    (root / "times.txt").write_text("\n".join(f"{0.1 * i:.6e}" for i in range(n)) + "\n")
    for d in ("image_0", "image_1"):
        (root / d).mkdir()
        for i in range(n):
            cv2.imwrite(str(root / d / f"{i:06d}.png"), (rng.rand(30, 50) * 255).astype(np.uint8))


def _write_tum_rgbd(root, n=4):
    rng = np.random.RandomState(2)
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb = ["# color images", "# file: 'rgbd_dataset'", "# timestamp filename"]
    dep = ["# depth maps", "# file: 'rgbd_dataset'", "# timestamp filename"]
    for i in range(n):
        t = 1305031102.175304 + i / 30.0
        cv2.imwrite(str(root / "rgb" / f"{t:.6f}.png"), (rng.rand(24, 32, 3) * 255).astype(np.uint8))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        td = t + 0.004 * (i - 1)          # depth stamps off by a few ms
        cv2.imwrite(str(root / "depth" / f"{td:.6f}.png"),
                    (rng.rand(24, 32) * 20000).astype(np.uint16))
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
    dep.append(f"{t + 0.5:.6f} depth/none.png")    # no rgb within 20 ms
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    gt = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(3 * n):
        gt.append(f"{1305031102.17 + i / 100:.4f} 1.3 0.6 {1.6 + i * 0.01:.4f} 0.65 0.62 -0.29 -0.33")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")


def _write_csv(root, n=3):
    rng = np.random.RandomState(3)
    rows = ["#timestamp,filename"]
    for i in range(n):
        t = 1700000000123456789 + i * 33_333_333 if i % 2 else 12.5 + i
        cv2.imwrite(str(root / f"f{i}.png"), (rng.rand(20, 28) * 255).astype(np.uint8))
        rows.append(f"{t},f{i}.png")
    (root / "seq.csv").write_text("\n".join(rows) + "\n")


LOADERS = {
    "euroc": (_write_euroc, lambda m, r: m.load_euroc(r, stereo=True, with_imu=True)),
    "euroc_mono": (_write_euroc, lambda m, r: m.load_euroc(r, cam="cam1")),
    "tum_vi": (_write_euroc, lambda m, r: m.load_tum_vi(r, stereo=True, with_imu=True)),
    "kitti": (_write_kitti, lambda m, r: m.load_kitti(r, stereo=True)),
    "tum_rgbd": (_write_tum_rgbd, lambda m, r: m.load_tum_rgbd(r)),
    "csv": (_write_csv, lambda m, r: m.load_csv_sequence(os.path.join(r, "seq.csv"), r)),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_match_tpuslam(tmp_path, name):
    write, load = LOADERS[name]
    write(tmp_path)
    got, want = load(datasets, str(tmp_path)), load(j_datasets, str(tmp_path))
    assert len(got) == len(want) > 0
    assert got.times.dtype == want.times.dtype and np.array_equal(got.times, want.times)
    for k in ("paths", "paths_right", "depth_paths"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("imu", "gt"):
        assert _same_array(getattr(got, k), getattr(want, k)), k
    for i in range(len(got)):
        a, b = got.frame(i), want.frame(i)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        if got.paths_right is not None:
            assert np.array_equal(got.frame_right(i), want.frame_right(i))
        if got.depth_paths is not None:
            a, b = got.depth(i, 5000.0), want.depth(i, 5000.0)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if got.imu is not None:
        t0, t1 = float(got.times[0]), float(got.times[1])
        assert np.array_equal(got.imu_between(t0, t1), want.imu_between(t0, t1))
    if name == "euroc":
        assert len(got) == 3 and got.imu.shape == (40, 7) and got.gt.shape == (16, 8)
    if name == "tum_rgbd":
        assert len(got) == 4 and got.gt.shape == (12, 8)


# ---------------------------------------------------------------- rectify
def _euroc_like(scale=1.0):
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    th = 0.01
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    P = np.array([[435.2046959714599, 0, 367.4517211914062, 0],
                  [0, 435.2046959714599, 252.2008514404297, 0], [0, 0, 1, 0]])
    S = np.diag([scale, scale, 1.0])
    return S @ K, D, R, S @ P


@pytest.mark.parametrize("D5", [False, True])
def test_rectify_maps_and_remap_match_tpuslam(D5):
    K, D, R, P = _euroc_like(0.25)
    if D5:
        D = np.append(D, 0.01)
    H, W = 120, 188       # the source image; the maps cover 130 x 200, past its edges
    mx, my = rectify.build_rectify_map(K, D, R, P, H + 10, W + 12)
    jx, jy = j_rectify.build_rectify_map(K, D, R, P, H + 10, W + 12)
    assert mx.dtype == jx.dtype == np.float32
    assert np.array_equal(mx, jx) and np.array_equal(my, jy)
    img = (np.random.RandomState(4).rand(H, W) * 255).astype(np.float32)
    got = rectify.remap_bilinear(torch.tensor(img), torch.tensor(mx), torch.tensor(my)).numpy()
    want = np.asarray(j_rectify.remap_bilinear(img, mx, my))
    assert np.abs(got - want).max() <= 1e-4
    assert (got == 0).sum() == (want == 0).sum() > 0          # BORDER_CONSTANT
    rec = rectify.StereoRectifier(dict(K=K, D=D, R=R, P=P), dict(K=K, D=D, R=np.eye(3), P=P),
                                  H, W, device="cpu")
    jrec = j_rectify.StereoRectifier(dict(K=K, D=D, R=R, P=P), dict(K=K, D=D, R=np.eye(3), P=P),
                                     H, W)
    for a, b in zip(rec(img, img[::-1].copy()), jrec(img, img[::-1].copy())):
        assert a.dtype == np.float32 and np.abs(a - b).max() <= 1e-4


def test_identity_rectification_gives_back_the_input():
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    P = np.concatenate([K, np.zeros((3, 1))], 1)
    side = dict(K=K, D=np.zeros(5), R=np.eye(3), P=P)
    rec = rectify.StereoRectifier(side, side, 60, 80, device="cpu")
    img = np.random.RandomState(5).randint(0, 256, (60, 80)).astype(np.uint8)
    out_l, out_r = rec(img, img)
    assert np.abs(out_l - img).max() <= 1e-4 and np.abs(out_r - img).max() <= 1e-4
    dev_l, _ = rec.rectify(img, img)
    assert torch.is_tensor(dev_l) and dev_l.device == rec.device


# ----------------------------------------------------------- vocabularies
def _irregular_tree():
    """tests/test_orbvoc.py's k=2, L=2 tree: an early leaf at level 0."""
    d = np.zeros((5, 256), np.uint8)
    d[2, :] = 1
    d[3, :10] = 1
    d[4, 128:138] = 1
    lines = [(0, 0, d[1], 0.0), (0, 1, d[2], 0.7), (1, 1, d[3], 0.3), (1, 1, d[4], 0.5)]
    return d, lines


def _write_text_voc(path, k, L, lines):
    with open(path, "w") as f:
        f.write(f"{k} {L}  0 3\n")
        for parent, is_leaf, bits, weight in lines:
            by = np.packbits(bits, bitorder="big")
            f.write(f"{parent} {int(is_leaf)} " + " ".join(str(int(b)) for b in by)
                    + f" {weight}\n")


def _same_tree(a, b):
    assert (a.k, a.L, a.node_level) == (b.k, b.L, b.node_level)
    assert len(a.level_descs) == len(b.level_descs)
    for x, y in zip(a.level_descs, b.level_descs):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.word_weight.dtype == b.word_weight.dtype
    assert np.array_equal(a.word_weight, b.word_weight)
    assert _same_array(a.leaf_word, b.leaf_word)


@pytest.mark.parametrize("tree", ["trained", "irregular"])
def test_orbvoc_and_npz_match_tpuslam(tmp_path, tree):
    if tree == "trained":
        descs = (np.random.RandomState(6).rand(300, 256) > 0.5).astype(np.uint8)
        jvoc = j_train_vocabulary(descs, k=3, L=2, seed=0)
        voc = vocab_from_numpy(jvoc.k, jvoc.L, jvoc.level_descs, jvoc.word_weight,
                               jvoc.node_level, jvoc.leaf_word)
        for ext, save, jsave in (("txt", save_orbvoc_text, j_orbvoc.save_orbvoc_text),
                                 ("bin", save_orbvoc_binary, j_orbvoc.save_orbvoc_binary)):
            save(voc, str(tmp_path / f"port.{ext}"))
            jsave(jvoc, str(tmp_path / f"ref.{ext}"))
            assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()
        files = ["port.txt", "port.bin"]
    else:
        _, lines = _irregular_tree()
        _write_text_voc(str(tmp_path / "port.txt"), 2, 2, lines)
        files = ["port.txt"]
    for f in files:
        got, want = load_orbvoc(str(tmp_path / f)), j_orbvoc.load_orbvoc(str(tmp_path / f))
        _same_tree(got, want)
        store.save_vocabulary(got, str(tmp_path / "port.npz"))
        j_store.save_vocabulary(want, str(tmp_path / "ref.npz"))
        zp, zr = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype and np.array_equal(zp[k], zr[k]), k
        _same_tree(store.load_vocabulary(str(tmp_path / "ref.npz")), want)
        _same_tree(store.load_vocabulary(str(tmp_path / "port.npz")),
                   j_store.load_vocabulary(str(tmp_path / "port.npz")))
    if tree == "irregular":
        q = np.stack(_irregular_tree()[0][2:])
        word, _, _ = got.transform(q, np.ones(3, bool), device="cpu")
        assert word.tolist() == [0, 1, 2]


# ------------------------------------------------------------- checkpoint
def _build_map(store_mod, ff_cls, seed=7):
    """The same small map through either package's SlamMap calls."""
    rng = np.random.RandomState(seed)
    m = store_mod(n_feat=8)

    def feats():
        return ff_cls(xy=rng.rand(8, 2), und_xy=rng.rand(8, 2), norm_xy=rng.rand(8, 2),
                      octave=rng.randint(0, 8, 8).astype(np.int32), angle=rng.rand(8),
                      response=rng.rand(8), bits=rng.randint(0, 2, (8, 256)).astype(np.uint8),
                      packed=rng.randint(0, 2 ** 31, (8, 8)).astype(np.uint32),
                      valid=np.ones(8, bool), depth=rng.rand(8) * 5, u_right=rng.rand(8) * 100)

    k0 = m.add_keyframe(np.eye(3), np.zeros(3), feats(), 0.0, 0)
    k1 = m.add_keyframe(np.eye(3), np.array([0.1, 0, 0]), feats(), 0.5, 5)
    k2 = m.add_keyframe(np.eye(3), np.array([0.2, 0.01, 0]), feats(), 1.0, 10)
    for s in range(6):
        mp = m.add_point(rng.rand(3) + [0, 0, 3], k0, s)
        m.add_observation(mp, k1, s)
        if s % 2:
            m.add_observation(mp, k2, s + 1)
    m.kf_preint[k1] = {"dR": rng.rand(3, 3), "dT": np.float64(0.5)}
    m.kf_imu[k1] = (rng.rand(4, 3), rng.rand(4, 3), np.full(4, 0.005))
    m.kf_tcp[k2] = (np.eye(3), np.array([0.0, 0.1, 0.0]))
    for k in (k1, k2):
        m.update_connections(k, th=1)
    m.imu_initialized = True
    m.map_version = 3
    return m


def test_checkpoint_keys_dtypes_and_round_trip(tmp_path):
    m, jm = _build_map(SlamMap, FrameFeatures), _build_map(JSlamMap, JFrameFeatures)
    checkpoint.save_map(m, str(tmp_path / "port.npz"))
    j_checkpoint.save_map(jm, str(tmp_path / "ref.npz"))
    zp, zr = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(zp.files) == sorted(zr.files)
    for k in zr.files:
        assert zp[k].dtype == zr[k].dtype and zp[k].shape[1:] == zr[k].shape[1:], k
        if k != "_blob":            # the blob pickles each package's own classes
            assert np.array_equal(zp[k], zr[k]), k
    m2 = checkpoint.load_map(SlamMap(n_feat=8), str(tmp_path / "port.npz"))
    for name in checkpoint._ARRAY_FIELDS + ("scale_factors",):
        a, b = getattr(m2, name), getattr(m, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in checkpoint._SCALARS:
        assert getattr(m2, name) == getattr(m, name) and type(getattr(m2, name)) is type(
            getattr(m, name)), name
    assert m2.mp_obs == m.mp_obs and m2.covis == m.covis
    for f2, f in zip(m2.kf_feats, m.kf_feats):
        assert (f2 is None) == (f is None)
        if f is not None:
            assert isinstance(f2, FrameFeatures)
            for k in ("xy", "octave", "bits", "packed", "valid", "depth", "u_right"):
                assert np.array_equal(getattr(f2, k), getattr(f, k)), k
    assert m2.kf_imu[1][2].tolist() == m.kf_imu[1][2].tolist() and m2.kf_tcp[2][1][1] == 0.1
    assert m2.best_covisible(1) == m.best_covisible(1) and m2._native is not None
    assert m2._native.count(1) == m.mp_obs[1].__len__()
    # the blob refuses device state
    m.kf_preint[2] = {"dR": torch.eye(3)}
    with pytest.raises(TypeError, match="torch tensor"):
        checkpoint.save_map(m, str(tmp_path / "bad.npz"))
