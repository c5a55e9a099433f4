"""The port stands alone and runs on the card by default.

  * No module of tpuslam_torch, and nothing in chip_smoke.py,
    bench_dist_torch.py, bench_torch.py, bench_sensors_torch.py,
    bench_frontend_torch.py, the scripts/*_torch.py files and the tests'
    helpers that chip_smoke.py imports (tests/torch_vi_heave.py,
    tests/torch_fisheye_rig.py, tests/torch_vi_merge.py, tests/torch_async.py,
    tests/torch_mono_vi_merge.py, tests/torch_datasets.py) and tests/torch_mono_merge.py and
    tests/torch_records.py,
    imports tpuslam or jax, nor what the card host lacks: cv2, yaml,
    matplotlib, PIL (a
    subprocess with all of them blocked imports them all and writes a
    TUM-VI tree with make_synth_euroc_torch.write_tum_vi, and a KITTI
    sequence, a TUM RGB-D recording and a CSV sequence that the port's
    loaders and settings read back; tpuslam_torch.viz imports
    matplotlib only when it draws). The helpers import nothing but the
    port and numpy (torch_async: the standard library), and
    scripts/tum_vi_examples_torch.sh and
    scripts/euroc_examples_torch.sh drive the port's CLI.
  * Every entry point defaults to the card: without one it raises, it
    never carries on on the CPU. scripts/vi_f32_experiment_torch.py's
    --stereo takes the heave trajectory of tests/torch_vi_heave.py.
  * The port's own copies of tpuslam's jax-free helpers (utils/pad,
    parallel/async_mapping, the native map core) behave as tpuslam's do.
  * A matrix that torch.linalg cannot factorize gives NaN results, as in
    jnp.linalg, and raises nothing (core/linalg.inv, solve, svd, eigh and
    the sites that call them).
  * Forward-mode Jacobians may be taken in any thread (utils.jacfwd).
"""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tpuslam.native import NativeInvIndex as JNativeInvIndex
from tpuslam.native import NativeObsIndex as JNativeObsIndex
from tpuslam.parallel.async_mapping import AsyncMapper as JAsyncMapper
from tpuslam.utils import pad as j_pad
from tpuslam_torch import native
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.map.store import SlamMap
from tpuslam_torch.parallel.async_mapping import AsyncMapper
from tpuslam_torch.utils import pad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("tpuslam", "jax", "cv2", "yaml", "matplotlib", "PIL")
ISOLATED = r"""
import importlib, importlib.util, pkgutil, sys
BLOCKED = %r
for name in BLOCKED:
    sys.modules[name] = None
import tpuslam_torch
names = [m.name for m in pkgutil.walk_packages(tpuslam_torch.__path__, "tpuslam_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import bench_dist_torch
import bench_torch
import bench_sensors_torch
import bench_frontend_torch
scripts = {}
for script in ("scripts/make_synth_euroc_torch.py", "scripts/profile_system_torch.py",
               "scripts/profile_torch_step.py", "scripts/vi_prior_witness_torch.py",
               "scripts/vi_f32_experiment_torch.py", "scripts/async_vi_merge_lags_torch.py",
               "scripts/trace_async_vi_merge_torch.py"):
    spec = importlib.util.spec_from_file_location("script", script)
    scripts[script] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scripts[script])
sys.path.insert(0, "tests")
import torch_vi_heave
import torch_fisheye_rig
import torch_vi_merge
import torch_async
import torch_mono_merge
import torch_records
import torch_mono_vi_merge
import torch_datasets
assert len(torch_vi_merge.heave_sessions(2, 1, 2)[1]) == 2
assert torch_mono_vi_merge.config().inertial.viba2_time == 1.0
assert torch_mono_merge.config().orb.n_features == torch_mono_merge.N_FEATURES
# the TUM-VI tree writer, on a 2-frame KB8 heave sequence at 64x64
import tempfile
cam, cam2, Trl = torch_fisheye_rig.kb8_rig(64)
seq = torch_vi_heave.heave_sequence(n_frames=2, camera=cam, camera2=cam2, Trl=Trl)
out = tempfile.mkdtemp()
scripts["scripts/make_synth_euroc_torch.py"].write_tum_vi(seq, out)
from tpuslam_torch.io.datasets import load_tum_vi
from tpuslam_torch.io.settings import load_settings
assert len(load_tum_vi(out, stereo=True, with_imu=True)) == 2
assert load_settings(out + "/tum_vi.yaml").camera2.kind == "kb8"
assert len(torch_records.text_digest(out + "/tum_vi.yaml")) == 64
# the KITTI, TUM RGB-D and CSV writers, on 2 frames at a tenth of the size
from tpuslam_torch.io import datasets
sc = torch_datasets.script()
kitti, tum = torch_datasets.kitti_sequence(2, 0.1), torch_datasets.tum_sequence(2, 0.1)
k_yaml, _ = sc.write_kitti(kitti, out + "/kitti")
t_yaml = sc.write_tum_rgbd(tum, out + "/tum")
c_csv, _ = sc.write_csv(torch_datasets.csv_sequence(2), out + "/csv")
assert load_settings(k_yaml).camera.width == 124 and len(datasets.load_kitti(out + "/kitti")) == 2
assert load_settings(t_yaml).cfg.depth_map_factor == 1 / 5000.0
assert datasets.load_tum_rgbd(out + "/tum").depth(1).max() > 0
assert len(datasets.load_csv_sequence(c_csv, out + "/csv")) == 2
# the long VI run's --stereo sequence (the heave helper, imported by the script)
vi_f32 = scripts["scripts/vi_f32_experiment_torch.py"]
assert type(vi_f32.sequence(3, stereo=True).traj) is torch_vi_heave.HeaveTrajectory
loaded = {k for k, v in sys.modules.items() if v is not None}
assert not {k for k in loaded if k.split(".")[0] in BLOCKED}, loaded
assert {"tpuslam_torch.run", "tpuslam_torch.io.settings", "tpuslam_torch.io.datasets",
        "tpuslam_torch.io.rectify", "tpuslam_torch.io.png", "tpuslam_torch.place.orbvoc",
        "tpuslam_torch.place.store", "tpuslam_torch.map.checkpoint",
        "tpuslam_torch.parallel.dist_ba", "tpuslam_torch.parallel.launch",
        "tpuslam_torch.viz"} <= set(names)
print("ISOLATED_OK", len(names))
""" % (BLOCKED,)


def test_port_imports_nothing_of_tpuslam_or_jax():
    """Nor cv2, yaml, matplotlib or PIL (see BLOCKED)."""
    res = subprocess.run([sys.executable, "-c", ISOLATED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED_OK" in res.stdout
    assert int(res.stdout.split()[-1]) > 40          # every module was walked


def _import_roots(helper):
    with open(os.path.join(ROOT, "tests", helper)) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    return roots


def test_heave_helper_imports_only_the_port_and_numpy():
    """tests/torch_vi_heave.py serves chip_smoke.py on the card host."""
    assert _import_roots("torch_vi_heave.py") == {"numpy", "tpuslam_torch"}


def test_fisheye_rig_helper_imports_only_the_port_and_numpy():
    """So does tests/torch_fisheye_rig.py."""
    assert _import_roots("torch_fisheye_rig.py") == {"numpy", "tpuslam_torch"}


def test_vi_merge_helper_imports_only_the_port_and_numpy():
    """So does tests/torch_vi_merge.py (phase 16's sessions), beside the
    standard library and the heave helper."""
    assert _import_roots("torch_vi_merge.py") == {"importlib", "os", "numpy", "tpuslam_torch",
                                                  "torch_vi_heave"}


def test_mono_merge_helper_imports_only_the_port_and_numpy():
    """So does tests/torch_mono_merge.py (the monocular merge's room),
    beside the standard library and torch."""
    assert _import_roots("torch_mono_merge.py") == {"importlib", "os", "numpy", "torch",
                                                    "tpuslam_torch"}


def test_mono_vi_merge_helper_imports_only_the_port_and_numpy():
    """So does tests/torch_mono_vi_merge.py (phase 17's sessions), beside
    torch and the stereo-inertial merge's helper."""
    assert _import_roots("torch_mono_vi_merge.py") == {"numpy", "torch", "tpuslam_torch",
                                                       "torch_vi_merge"}


def test_records_helper_imports_only_the_standard_library_and_numpy():
    """tests/torch_records.py (tpuslam's recorded lockstep sides) loads
    without jax."""
    assert _import_roots("torch_records.py") == {"gzip", "hashlib", "os", "pickle", "numpy"}


def test_datasets_helper_imports_only_the_port_and_numpy():
    """So does tests/torch_datasets.py (phase 18's sequences and gates),
    beside the standard library."""
    assert _import_roots("torch_datasets.py") == {"functools", "importlib", "os", "numpy",
                                                  "tpuslam_torch"}


def test_async_helper_imports_only_the_standard_library():
    """So does tests/torch_async.py (the async phases' back-pressure and
    handshake counter)."""
    assert _import_roots("torch_async.py") == {"threading", "time"}


def test_jacfwd_is_safe_in_any_thread():
    """Forward-mode AD keeps its dual levels in process-global state, so
    torch.func.jacfwd taken in two threads at once tears down the other's
    level ("Trying to access a forward AD level with an invalid index"):
    on the card the background FullInertialBA after a stereo-inertial merge
    (solve/inertial_ba.py) failed so beside the tracker's
    pose_inertial_solve. The port's utils.jacfwd evaluates under one
    process-wide lock, and every solver takes it: 8 threads with a short
    switch interval each get the
    single-thread Jacobians."""
    from tpuslam_torch.utils import jacfwd

    for path in (os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "tpuslam_torch"))
                 for f in fs if f.endswith(".py")):
        with open(path) as fh:
            calls = [n for n in ast.walk(ast.parse(fh.read()))
                     if isinstance(n, ast.Call) and ast.unparse(n.func) == "torch.func.jacfwd"]
        assert not calls or path.endswith(os.path.join("utils", "__init__.py")), path

    def f(x):
        return torch.sin(x) * x.sum() + torch.cos(2.0 * x)

    xs = [torch.randn(6, dtype=torch.float64, generator=torch.Generator().manual_seed(i))
          for i in range(8)]
    want = [torch.func.jacfwd(f)(x) for x in xs]
    got, errors = [None] * len(xs), []

    def work(i):
        try:
            for _ in range(100):
                got[i] = jacfwd(f)(xs[i])
        except RuntimeError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tum_vi_runner_drives_the_port():
    """scripts/tum_vi_examples_torch.sh runs the port's CLI, on the card
    unless DEVICE says otherwise, and never tpuslam's."""
    with open(os.path.join(ROOT, "scripts", "tum_vi_examples_torch.sh")) as fh:
        text = fh.read()
    assert "python -m tpuslam_torch.run --dataset tum_vi" in text
    assert "tpuslam.run" not in text
    assert '--device "${DEVICE:-cuda}"' in text


def test_euroc_runner_drives_the_port():
    """So does scripts/euroc_examples_torch.sh, its matrix and its
    multi-session line alike."""
    with open(os.path.join(ROOT, "scripts", "euroc_examples_torch.sh")) as fh:
        text = fh.read()
    assert text.count("python -m tpuslam_torch.run --dataset euroc") == 2
    assert "tpuslam.run" not in text
    assert text.count('--device "${DEVICE:-cuda}"') == 2


def _cam():
    return Pinhole([200.0, 200.0, 188.0, 120.0], 376, 240)


def _entry(name):
    """Build entry point `name` with its default device."""
    from tpuslam_torch.engine.frontend import Frontend
    from tpuslam_torch.engine.local_mapping import LocalMapper, window_ba
    from tpuslam_torch.engine.loop_closing import LoopCloser
    from tpuslam_torch.engine.map_device import MapDeviceKernels
    from tpuslam_torch.engine.system import System
    from tpuslam_torch.engine.track_device import FusedTrackStep
    from tpuslam_torch.engine.tracking import Tracker
    from tpuslam_torch.ops.match import match_padded
    from tpuslam_torch.place import train_vocabulary
    from tpuslam_torch.solve.ba import ba_solve_np
    from tpuslam_torch.solve.pose_graph import optimize_essential_graph

    cfg = SlamConfig(orb=OrbConfig(n_features=64))
    descs = (np.random.RandomState(0).rand(40, 256) > 0.5).astype(np.uint8)
    if name == "System":
        return System(_cam(), cfg)
    if name == "Tracker":
        return Tracker(_cam(), cfg, SlamMap(64))
    if name == "LocalMapper":
        return LocalMapper(_cam(), cfg, SlamMap(64))
    if name == "LoopCloser":
        vocab = train_vocabulary(descs, k=2, L=2, iters=1, device="cpu")
        return LoopCloser(_cam(), cfg, SlamMap(64), vocab)
    if name == "Frontend":
        return Frontend(_cam(), cfg.orb)
    if name == "MapDeviceKernels":
        return MapDeviceKernels(_cam(), np.ones(8), 3.0, 8)
    if name == "FusedTrackStep":
        return FusedTrackStep(_cam(), cfg.orb, TrackingConfig(), 8, 1.2, 20.0, True)
    if name == "train_vocabulary":
        return train_vocabulary(descs, k=2, L=2, iters=1)
    if name == "BinaryVocabulary.transform":
        vocab = train_vocabulary(descs, k=2, L=2, iters=1, device="cpu")
        return vocab.transform(descs, np.ones(len(descs), bool))
    if name == "window_ba":
        return window_ba(SlamMap(64), _cam(), None, np.ones(8), 20.0, [])
    if name == "ba_solve_np":
        return ba_solve_np(np.eye(3)[None], np.zeros((1, 3)), np.array([[0.0, 0.0, 2.0]]), [0],
                           [0], np.array([[100.0, 100.0, 0.0]]), [1.0], [False], [True], [True],
                           200.0, 200.0, 100.0, 100.0, 0.0, n_iters=1)
    if name == "optimize_essential_graph":
        return optimize_essential_graph(SlamMap(64), [], {}, 0)
    if name in ("preintegrate_window", "run_imu_init", "window_inertial_ba", "full_inertial_ba",
                "local_inertial_ba"):
        from tpuslam_torch.engine import inertial
        from tpuslam_torch.imu.preintegration import ImuCalib

        fn = getattr(inertial, name)
        if name == "preintegrate_window":
            return fn(np.zeros((0, 7)), 0.0, 0.1, np.zeros(3), np.zeros(3), ImuCalib())
        if name == "run_imu_init":
            return fn(SlamMap(64), ImuCalib())
        if name == "local_inertial_ba":
            return fn(SlamMap(64), 0, _cam(), ImuCalib(), np.ones(8))
        if name == "full_inertial_ba":
            return fn(SlamMap(64), _cam(), ImuCalib(), np.ones(8))
        return fn(SlamMap(64), _cam(), ImuCalib(), np.ones(8), [], [])
    if name == "run.main":
        return _run_main()
    if name in ("dist_ba_solve", "dist_viba_solve"):
        return _dist_entry(name)
    if name.startswith("vi_f32_experiment."):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "vi_f32_experiment_torch", os.path.join(ROOT, "scripts", "vi_f32_experiment_torch.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        return script.run(2) if name.endswith(".run") else script.main(["--frames", "2"])
    if name == "match_padded":
        return match_padded(np.zeros((0, 32), np.uint8), np.zeros((3, 32), np.uint8),
                            np.zeros((0, 3), bool))
    raise KeyError(name)


def _dist_entry(name):
    """A one-observation distributed solve with its default device, in a
    one-rank gloo group."""
    from tpuslam_torch.parallel import dist_ba, launch

    launch.init_rank(0, 1, launch.free_port(), "gloo", 60.0)
    try:
        obs = ([0], [0], np.array([[100.0, 100.0, 0.0]]), [1.0], [False], [True])
        pose = (np.eye(3)[None], np.zeros((1, 3)))
        X = np.array([[0.0, 0.0, 2.0]])
        if name == "dist_ba_solve":
            return dist_ba.dist_ba_solve(None, *pose, X, *obs, [True], 200.0, 200.0, 100.0,
                                         100.0, 0.0, n_iters=1)
        z = np.zeros((1, 3))
        pre = {k: np.zeros((0, 3)) for k in ("dR", "dV", "dP")}
        return dist_ba.dist_viba_solve(None, *pose, z, z, z, X, *obs, [], [], pre,
                                       np.zeros((0, 9, 9)), z, z, [], [], [True], 200.0, 200.0,
                                       100.0, 100.0, 0.0, np.eye(3), np.zeros(3), n_iters=1)
    finally:
        torch.distributed.destroy_process_group()


def _run_main():
    """The CLI with its default device on a one-frame EuRoC tree."""
    import tempfile

    from tpuslam_torch import run
    from tpuslam_torch.io.png import write_png

    root = tempfile.mkdtemp()
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"))
        write_png(os.path.join(root, "mav0", cam, "data", "0.png"), np.zeros((240, 376), np.uint8))
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as fh:
            fh.write("#timestamp [ns],filename\n0,0.png\n")
    with open(os.path.join(root, "s.yaml"), "w") as fh:
        fh.write("%YAML:1.0\nCamera.fx: 200.0\nCamera.fy: 200.0\nCamera.cx: 188.0\n"
                 "Camera.cy: 120.0\nCamera.width: 376\nCamera.height: 240\nCamera.bf: 20.0\n")
    return run.main(["--dataset", "euroc", "--path", root, "--settings",
                     os.path.join(root, "s.yaml"), "--sensor", "stereo",
                     "--output", os.path.join(root, "t.txt")])


@pytest.mark.parametrize("name", ["System", "Tracker", "LocalMapper", "LoopCloser", "Frontend",
                                  "MapDeviceKernels", "FusedTrackStep", "train_vocabulary",
                                  "BinaryVocabulary.transform", "window_ba", "ba_solve_np",
                                  "optimize_essential_graph", "match_padded",
                                  "preintegrate_window", "run_imu_init", "window_inertial_ba",
                                  "full_inertial_ba", "local_inertial_ba", "run.main",
                                  "dist_ba_solve", "dist_viba_solve", "vi_f32_experiment.run",
                                  "vi_f32_experiment.main"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        obj = _entry(name)
        dev = getattr(obj, "device", None)
        assert dev is None or torch.device(dev).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry(name)


@pytest.mark.parametrize("n,base", [(0, 128), (1, 128), (128, 128), (129, 128), (700, 256),
                                    (2049, 2048), (5000, 64)])
def test_pad_bucket_matches_tpuslam(n, base):
    assert pad.bucket(n, base) == j_pad.bucket(n, base)


@pytest.mark.parametrize("shape,n,fill", [((5, 3), 8, 0), ((4,), 4, 0), ((3,), 9, True),
                                          ((0, 2), 3, -1)])
def test_pad_to_matches_tpuslam(shape, n, fill):
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    if fill is True:
        arr = arr > 1
    got, want = pad.pad_to(arr, n, fill), j_pad.pad_to(arr, n, fill)
    assert got.dtype == want.dtype and np.array_equal(got, want)


class _Mapper:
    """Records the keyframes it maps; raises on kf 3."""

    def __init__(self):
        self.seen, self.abort_check = [], None

    def on_new_keyframe(self, kf, lock=None):
        with lock:
            self.seen.append(kf)
        if kf == 3:
            raise ValueError("boom")


class _Closer:
    def __init__(self):
        self.seen = []

    def on_new_keyframe(self, kf):
        self.seen.append(kf)


@pytest.mark.parametrize("cls", [AsyncMapper, JAsyncMapper], ids=["port", "tpuslam"])
def test_async_mapper_behaves_as_tpuslam(cls):
    lm, lc = _Mapper(), _Closer()
    mapper = cls(lm, lc, map_lock=threading.RLock())
    try:
        assert mapper.idle() and lm.abort_check() is False
        for kf in range(6):
            mapper.on_new_keyframe(kf)
        with pytest.raises(ValueError, match="boom"):
            mapper.flush()
        assert lm.seen == list(range(6)) and lc.seen == [0, 1, 2, 4, 5]
        assert len(mapper.errors) == 1 and mapper.idle()
    finally:
        mapper.shutdown()
    assert not mapper.worker.is_alive()


def test_native_core_is_the_port_own_build():
    assert native.available()                        # g++ is on this machine
    assert native.LIB.parent == native.BUILD_DIR and native.LIB.exists()
    assert "tpuslam_torch" in str(native.LIB) and native.SRC.parent.name == "native"
    assert SlamMap(16)._native is not None


def test_native_indices_match_tpuslam():
    rng = np.random.RandomState(0)
    ports, refs = native.NativeObsIndex(), JNativeObsIndex()
    for _ in range(300):
        mp, kf, slot = rng.randint(0, 40), rng.randint(0, 12), rng.randint(0, 64)
        assert ports.add(mp, kf, slot) == refs.add(mp, kf, slot)
    for _ in range(40):
        mp, kf = rng.randint(0, 40), rng.randint(0, 12)
        assert ports.erase(mp, kf) == refs.erase(mp, kf)
    for mp in range(40):
        assert ports.count(mp) == refs.count(mp)
        for a, b in zip(ports.items(mp), refs.items(mp)):
            assert np.array_equal(a, b)
    row = rng.randint(-1, 40, 64).astype(np.int32)
    for a, b in zip(ports.covis_counts(0, row), refs.covis_counts(0, row)):
        assert np.array_equal(a, b)
    oct_ = rng.randint(0, 8, (12, 64)).astype(np.int8)
    assert ports.redundancy(0, row, oct_) == refs.redundancy(0, row, oct_)

    porti, refi = native.NativeInvIndex(50), JNativeInvIndex(50)
    for kf in range(8):
        words = np.unique(rng.randint(0, 50, 12))
        weights = rng.rand(len(words)).astype(np.float32)
        porti.add(kf, words, weights)
        refi.add(kf, words, weights)
    assert porti.erase(3) == refi.erase(3)
    q = np.unique(rng.randint(0, 50, 10))
    qw = rng.rand(len(q)).astype(np.float32)
    for a, b in zip(porti.shared(q, [1]), refi.shared(q, [1])):
        assert np.array_equal(a, b)
    for kf in range(8):
        assert porti.score(kf, q, qw) == refi.score(kf, q, qw)


# ------------------------------------------- linalg failures as in jnp.linalg
def _bad_batch(kind, symmetric):
    """A batch of three 3x3 matrices; the middle one singular (kind
    'singular') or with a NaN entry ('nan')."""
    A = np.random.RandomState(7).randn(3, 3, 3) + 3 * np.eye(3)
    A = A @ np.swapaxes(A, -1, -2) if symmetric else A
    if kind == "singular":
        A[1] = [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]]
    else:
        A[1, 1, 2] = A[1, 2, 1] = np.nan
    return A


@pytest.mark.parametrize("fn,kind", [("inv", "singular"), ("solve", "singular"), ("svd", "nan"),
                                     ("eigh", "nan")])
def test_linalg_failure_gives_nan_as_jnp(fn, kind):
    """The middle matrix of the batch cannot be factorized: torch.linalg
    raises on it, the port's helper gives NaN there as jnp.linalg does, and
    the other entries agree with jnp.linalg within 1e-10."""
    import jax.numpy as jnp

    from tpuslam_torch.core import linalg

    A = _bad_batch(kind, fn == "eigh")
    B = np.random.RandomState(8).randn(3, 3, 2)
    args, jargs = (A, B) if fn == "solve" else (A,), (jnp.asarray(A), jnp.asarray(B))
    jargs = jargs if fn == "solve" else jargs[:1]
    with pytest.raises(torch.linalg.LinAlgError):
        getattr(torch.linalg, fn)(*(torch.tensor(a) for a in args))
    got = getattr(linalg, fn)(*(torch.tensor(a) for a in args))
    want = getattr(jnp.linalg, fn)(*jargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    # the factor that is unique: values, or singular / eigen-values
    pick = {"inv": 0, "solve": 0, "svd": 1, "eigh": 0}[fn]
    g, w = got[pick].numpy(), np.asarray(want[pick])
    assert not np.isfinite(w[1]).all() and np.isnan(g[1]).all()
    np.testing.assert_allclose(g[[0, 2]], w[[0, 2]], rtol=1e-10, atol=1e-10)


def test_linalg_sites_give_nan_as_tpuslam():
    """Sites that raised on such a matrix now follow tpuslam: a homography
    hypothesis that cannot be inverted scores as in tpuslam's _score_h; a
    NaN rotation, point set or PnP problem gives NaN (normalize_rotation,
    horn_sim3, dlt_pose) where tpuslam's does."""
    import jax.numpy as jnp

    from tpuslam.core import lie as JL
    from tpuslam.ops import twoview as JTV
    from tpuslam.solve import pnp as JPNP
    from tpuslam.solve import sim3 as JSIM3
    from tpuslam_torch.core import lie as TL
    from tpuslam_torch.ops import twoview as TTV
    from tpuslam_torch.solve import pnp as TPNP
    from tpuslam_torch.solve import sim3 as TSIM3

    rng = np.random.RandomState(9)
    H = np.stack([np.eye(3) + 0.01 * rng.randn(3, 3), np.zeros((3, 3))])
    x1 = rng.rand(20, 2) * 100
    x2 = x1 + rng.randn(20, 2) * 0.5
    valid = np.ones(20, bool)
    got = TTV._score_h(torch.tensor(H), torch.tensor(x1), torch.tensor(x2), 1.0,
                       torch.tensor(valid))
    want = JTV._score_h(jnp.asarray(H), jnp.asarray(x1), jnp.asarray(x2), 1.0,
                        jnp.asarray(valid))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-9)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    R = np.full((3, 3), np.nan)
    X = rng.randn(12, 3)
    X[3, 1] = np.nan
    xy = rng.rand(12, 2)
    for got, want in ((TL.normalize_rotation(torch.tensor(R)), JL.normalize_rotation(R)),
                      (TSIM3.horn_sim3(torch.tensor(X), torch.tensor(X + 1.0))[1],
                       JSIM3.horn_sim3(jnp.asarray(X), jnp.asarray(X + 1.0))[1]),
                      (TPNP.dlt_pose(torch.tensor(X), torch.tensor(xy))[0],
                       JPNP.dlt_pose(jnp.asarray(X), jnp.asarray(xy))[0])):
        assert not np.isfinite(np.asarray(want)).all()
        assert not np.isfinite(got.numpy()).all()
