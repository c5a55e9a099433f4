"""Run one side of a lockstep test in a process of its own.

A lockstep test feeds tpuslam's System and the port's the same frames and
compares them frame by frame; neither System reads the other, so each can
run on its own and the comparison can follow. `start(fn, *args)` runs the
module-level function fn(*args) in a spawned process, set up as
tests/conftest.py sets up the test process (JAX on the CPU, x64, the
persistent compilation cache), and returns a future for its picklable
result, while the caller runs the other side. The two sides then take their
CPU time side by side instead of one after the other.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor


def _setup():
    import conftest  # noqa: F401  (its module-level JAX setup)


def start(fn, *args):
    """fn(*args) in a spawned process; a concurrent.futures.Future."""
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_setup)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future
