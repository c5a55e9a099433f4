"""tpuslam's side of the heaviest lockstep tests, recorded.

A lockstep test feeds tpuslam's System and the port's the same inputs and
compares them. tpuslam is the fixed reference: its run on given inputs does
not change, so these tests read its side from tests/data/tpuslam/<name>.pkl.gz,
written by tests/make_tpuslam_records.py with the test module's own tpuslam
function on the inputs the test builds, instead of running it again on every
test run. Each record keeps fingerprints of those inputs (the frames, the
vocabulary or settings file), and `load` checks them against the inputs the
test built, so a record that no longer matches its test fails the test
instead of passing on stale data. The frames are compared to 1e-6 and the
files' numbers to 9 significant digits, so a last-digit difference of the
host's floating point does not count as other inputs. Imports only the
standard library and numpy.
"""

import gzip
import hashlib
import os
import pickle

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tpuslam")


def text_digest(path):
    """sha256 of a text file with every number in it rounded to 9
    significant digits."""
    def norm(tok):
        try:
            return f"{float(tok):.9g}"
        except ValueError:
            return tok

    h = hashlib.sha256()
    with open(path) as fh:
        for line in fh:
            h.update(" ".join(norm(t) for t in line.split()).encode() + b"\n")
    return h.hexdigest()


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.shape(a) == np.shape(b) and np.allclose(a, b, rtol=0.0, atol=1e-6)
    return a == b


def _path(name):
    return os.path.join(DIR, f"{name}.pkl.gz")


def save(name, result, inputs):
    """Write tpuslam's result for the named test with its inputs'
    fingerprints."""
    os.makedirs(DIR, exist_ok=True)
    with gzip.open(_path(name), "wb", compresslevel=9) as fh:
        pickle.dump({"inputs": inputs, "result": result}, fh, protocol=4)
    return os.path.getsize(_path(name))


def load(name, inputs):
    """tpuslam's recorded result for the named test; the fingerprints of
    the inputs the test built must match the record's."""
    with gzip.open(_path(name), "rb") as fh:
        rec = pickle.load(fh)
    if rec["inputs"].keys() != inputs.keys() or not all(
            _same(rec["inputs"][k], v) for k, v in inputs.items()):
        raise AssertionError(f"tests/data/tpuslam/{name}.pkl.gz was written for other inputs: "
                             f"rewrite it with tests/make_tpuslam_records.py {name}")
    return rec["result"]


def sequence_fingerprint(seq, n, right=False):
    """Fingerprint of a sequence's first n frames as the tests feed them:
    8x8-pixel block means of the first, middle and last images (and of
    their right images), the stamps and the IMU samples between the first
    and the last."""
    idx = sorted({0, n // 2, n - 1})
    ts = seq.timestamps()[:n]
    images = [seq.frame(i) for i in idx]
    if right:
        images += [seq.frame(i, right=True) for i in idx]
    blocks = [np.asarray(im, np.float64)[: im.shape[0] // 8 * 8, : im.shape[1] // 8 * 8]
              .reshape(im.shape[0] // 8, 8, im.shape[1] // 8, 8).mean((1, 3)) for im in images]
    imu = np.concatenate([np.ravel(x) for x in seq.imu_between(ts[0], ts[-1])])
    return np.concatenate([np.ravel(b) for b in blocks] + [np.asarray(ts, np.float64), imu])


class recorded:
    """The record in the form of tests/torch_child.start's future:
    result() gives tpuslam's result."""

    def __init__(self, name, inputs):
        self.value = load(name, inputs)

    def result(self):
        return self.value
