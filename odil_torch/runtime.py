"""Runtime configuration: default dtype and the fp32 pin.

PyTorch counterpart of ``odil_tpu/runtime.py``.  Knobs are read when a
function is called, never when the module is imported, so a caller (or a
test) that sets ``ODIL_DTYPE`` after importing the package still takes
effect.  There is no TensorFlow shim and no compilation cache: PyTorch runs
eagerly, and the CUDA kernels build on first use (``ops/_build.py``).

Environment variable ``ODIL_DTYPE``: ``float32`` (default) or ``float64``.
"""

import os

import numpy as np
import torch

__all__ = ["default_dtype", "pin_fp32", "torch_dtype"]


def default_dtype():
    """The default floating dtype (numpy), from ``ODIL_DTYPE`` at call time."""
    name = os.environ.get("ODIL_DTYPE", "float32")
    if name not in ("float32", "float64"):
        raise ValueError(f"Expected ODIL_DTYPE=float32 or float64, got {name!r}")
    return np.dtype(name)


def torch_dtype(dtype):
    """Maps a numpy/torch/str dtype to the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64}[np.dtype(dtype)]


def pin_fp32():
    """Keeps fp32 matrix products and convolutions in full fp32.

    Reduced-precision (TF32) prolongation leaves the converged flagship
    loss 54% above the reference (BENCH_NOTES.md:526-588), so the port
    never allows it.  Called by ``Domain``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
