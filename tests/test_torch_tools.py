"""The port's measuring tools (bench_torch.py, bench_frontend_torch.py,
bench_sensors_torch.py, scripts/profile_system_torch.py) on the CPU at a
tiny size, each in a process where tpuslam, jax and what the card host
lacks cannot be imported: they run to the end and print tpuslam's metric
names and JSON fields. Without a card, each tool raises unless given
--device cpu. bench_frontend_torch.entry() runs one forward on the CPU on
__graft_entry__.entry()'s example inputs.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_frontend  # noqa: E402
import bench_frontend_torch  # noqa: E402
import bench_sensors_torch  # noqa: E402
import bench_torch  # noqa: E402

torch.set_num_threads(2)
BLOCKED = ("tpuslam", "jax", "cv2", "yaml", "matplotlib", "PIL")
RUN = r"""
import runpy, sys
for name in %r:
    sys.modules[name] = None
import torch
torch.set_num_threads(2)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
""" % (BLOCKED,)
BENCH_FIELDS = {"metric", "value", "unit", "vs_baseline"}


def run_tool(*argv):
    """python <tool> <args> with the blocked modules; its stdout and
    stderr."""
    res = subprocess.run([sys.executable, "-c", RUN, *argv], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout, res.stderr


def json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_bench_torch_on_the_cpu():
    out, err = run_tool("bench_torch.py", "--device", "cpu", "--frames", "24", "--passes", "1",
                        "--size", "376x240", "--features", "300")
    (row,) = json_lines(out)
    assert set(row) == BENCH_FIELDS and row["unit"] == "frames/s"
    assert row["metric"] == "system_track_stereo_fps_376x240_300feat"
    # both are rounded from the same unrounded fps, as bench.py does: they
    # agree within the two roundings (0.005 / 20 + 0.0005)
    assert row["value"] > 0 and abs(row["vs_baseline"] - row["value"] / 20.0) <= 0.00075 + 1e-12
    assert err.count("bench pass: ") == 1 and "'state': 'OK'" in err
    assert "bench median pass: " in err and "'device': 'cpu'" in err
    # bench.py's protocol and headline name at the defaults
    assert (bench_torch.N_FRAMES, bench_torch.WARM_FRAMES) == (bench.N_FRAMES,
                                                               bench.WARM_FRAMES)
    assert (f"system_track_stereo_fps_{bench_torch.WIDTH}x{bench_torch.HEIGHT}_"
            f"{bench_torch.N_FEATURES}feat") == "system_track_stereo_fps_752x480_1024feat"


def test_bench_frontend_torch_on_the_cpu():
    out, _ = run_tool("bench_frontend_torch.py", "--device", "cpu", "--frames", "3", "--size",
                      "376x240", "--features", "300")
    (row,) = json_lines(out)
    assert set(row) == BENCH_FIELDS and row["value"] > 0
    assert row["metric"] == "tracking_frontend_fps_376x240_300feat"
    assert bench_frontend_torch.N_FRAMES == bench_frontend.N_FRAMES


@pytest.mark.parametrize("sensor,metric", [
    ("rgbd", "system_track_rgbd_376x240_700feat_fps"),
    ("fisheye", "system_track_fisheye_stereo_256x256_700feat_fps"),
    ("vi", "system_track_mono_vi_376x240_600feat_fps"),
])
def test_bench_sensors_torch_row_on_the_cpu(sensor, metric):
    """bench_sensors.py's row names; 10 frames, so 2 outside the 8 warm
    ones."""
    out, err = run_tool("bench_sensors_torch.py", "--device", "cpu", "--frames", "10",
                        "--sensors", sensor)
    (row,) = json_lines(out)
    assert set(row) == BENCH_FIELDS | {"median_ms", "state", "kfs"}
    assert row["metric"] == metric and row["value"] > 0 and row["median_ms"] > 0
    assert row["state"] == "OK" and row["kfs"] >= 1 and "done" in err


def test_bench_sensors_torch_refuses_an_unknown_sensor():
    with pytest.raises(ValueError, match="unknown sensors"):
        bench_sensors_torch.main(["--device", "cpu", "--sensors", "rgbd,lidar"])


def test_profile_system_torch_on_the_cpu():
    out, _ = run_tool("scripts/profile_system_torch.py", "--device", "cpu", "--frames", "10",
                      "--features", "300", "--async-mapping", "--pipelined")
    assert "=== run 0 on cpu: 10 frames" in out and "steady-state:" in out
    assert "track_fused" in out and "state=State.OK" in out
    ate = float(out.split("ATE (unscaled) = ")[1].split()[0])
    assert 0.0 <= ate < 0.05


def test_entry_runs_one_forward_on_the_cpu():
    forward, args = bench_frontend_torch.entry(device="cpu")
    pose, assoc, rowflags = forward(*args)
    assert pose.shape == (13,) and bool(pose.isfinite().all())
    assert assoc.shape == (1024,) and rowflags.shape == (4096,)
    R = pose[:9].reshape(3, 3).double()
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-4)


def test_entry_inputs_are_graft_entry_inputs():
    import __graft_entry__

    _, want = __graft_entry__.entry()
    got = bench_frontend_torch.graft_inputs()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _profile_main():
    spec = importlib.util.spec_from_file_location(
        "profile_system_torch", os.path.join(ROOT, "scripts", "profile_system_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.mark.parametrize("tool", ["bench_torch", "bench_frontend_torch", "bench_sensors_torch",
                                  "profile_system_torch", "entry"])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if tool == "entry":
            bench_frontend_torch.entry()
        elif tool == "profile_system_torch":
            _profile_main()([])
        else:
            sys.modules[tool].main([])
