"""Write tpuslam's side of the heaviest lockstep tests into tests/data/tpuslam/
(tests/torch_records.py says why and how the tests read it).

    python tests/make_tpuslam_records.py [NAME ...]

(from the repo root, on the CPU; every record when no NAME is given. Each
runs the test module's own tpuslam function in the process set up as the
tests' (tests/conftest.py: JAX on the CPU, x64), and keeps the fingerprints
of the inputs it ran on; ~2-6 min a record.)
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import conftest  # noqa: E402,F401  (its module-level JAX setup)
import importlib  # noqa: E402

import torch_records  # noqa: E402


def _module(name):
    return importlib.import_module(name)


def _plain(module, fn, *args):
    """A test module whose tpuslam function builds its own inputs."""
    def record(tmp):
        mod = _module(module)
        return getattr(mod, fn)(*args), mod._record_inputs()
    return record


def _atlas_merge(tmp):
    mod = _module("test_torch_atlas_merge")
    room = mod._make_room(os.path.join(tmp, "voc.txt"))
    return mod._tpuslam_side(room), mod.record_inputs(room)


def _async_merge(tmp):
    atlas = _module("test_torch_atlas_merge")
    room = atlas._make_room(os.path.join(tmp, "voc.txt"))
    return _module("test_torch_async_merge")._run("tpuslam", room), atlas.record_inputs(room)


def _vi_merge(tmp):
    import torch_vi_merge

    mod = _module("test_torch_vi_merge")
    seq, _ = torch_vi_merge.heave_sessions()
    voc = torch_vi_merge.vocabulary_text(seq, os.path.join(tmp, "voc.txt"))
    return mod._run("tpuslam", voc), mod.record_inputs(seq, voc)


def _mono_vi_merge(tmp):
    import torch_mono_vi_merge
    import torch_vi_merge

    mod = _module("test_torch_mono_vi_merge")
    seq, _ = torch_mono_vi_merge.sessions()
    voc = torch_vi_merge.vocabulary_text(seq, os.path.join(tmp, "voc.txt"))
    return mod._tpuslam_to_the_merge(voc), mod.record_inputs(seq, voc)


def _tum_vi_cli(tmp):
    mod = _module("test_torch_tum_vi_cli")
    tree = mod.write_tree(os.path.join(tmp, "room1"))
    return mod._tpuslam_runs(tree[1], tree[2]), mod.record_inputs(tree)


def _dataset_cli(module):
    """A dataset-CLI test module's tpuslam runs on its written tree."""
    def record(tmp):
        mod = _module(module)
        tree = mod.write_tree(os.path.join(tmp, "tree"))
        return mod._tpuslam_runs(*tree[1:]), mod.record_inputs(tree)
    return record


# record name -> its writer: (a scratch directory) -> (tpuslam's result, input fingerprints)
RECORDS = {
    "vi_system": _plain("test_torch_vi_system", "_tpuslam_slice"),
    "stereo_inertial": _plain("test_torch_stereo_inertial", "_tpuslam_slice"),
    "fisheye_mono": _plain("test_torch_fisheye_mono", "_tpuslam_slice"),
    "fisheye_inertial": _plain("test_torch_fisheye_inertial", "_tpuslam_slice"),
    "vi_schedule": _plain("test_torch_vi_schedule", "_tpuslam_run"),
    "async_stereo_inertial": _plain("test_torch_async_stereo_inertial", "_run", "tpuslam"),
    "atlas_merge": _atlas_merge,
    "async_merge": _async_merge,
    "vi_merge": _vi_merge,
    "mono_vi_merge": _mono_vi_merge,
    "tum_vi_cli": _tum_vi_cli,
    "kitti_cli": _dataset_cli("test_torch_kitti_cli"),
    "tum_rgbd_cli": _dataset_cli("test_torch_tum_rgbd_cli"),
    "csv_cli": _dataset_cli("test_torch_csv_cli"),
}


def main(names):
    for name in names or RECORDS:
        with tempfile.TemporaryDirectory() as tmp:
            result, inputs = RECORDS[name](tmp)
        size = torch_records.save(name, result, inputs)
        print(f"wrote tests/data/tpuslam/{name}.pkl.gz: {size / 1e6:.2f} MB", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
