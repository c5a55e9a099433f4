"""PyTorch/CUDA port of tpuslam.

Module paths mirror `tpuslam/` one to one; a Pallas module `x_pallas.py`
becomes `x_cuda.py`, whose wrapper launches a hand-written CUDA kernel
(`csrc/`, built at first use by `_build.py`) on CUDA tensors and runs the
plain PyTorch version of the same function on CPU tensors.

This package imports torch and numpy, never jax.
"""
