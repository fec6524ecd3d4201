"""Probe kernels of the port's roofline and kernel-ablation tools.

PyTorch/CUDA counterparts of the two Pallas probes of the JAX package's
tools (``csrc/probes.cu``):

  copy3(a, b, c) -> (a2, b2, c2): three fp32 arrays copied into three new
      ones (``benchmarks/roofline.py:120-136``), the achievable HBM copy rate
      over the flagship's three fine arrays;
  fma(x, k=128): k steps ``x = x * 1.0000001 + 1e-7`` on every element
      (``benchmarks/kernel_ablation.py:167-185``), the achievable fp32 FMA
      rate.

Each dispatches on the device of its tensors: a CUDA tensor launches the
kernel (``copy3_cuda``, ``fma_cuda``; a build or launch that fails raises),
a CPU tensor runs the plain version.  Both round each FMA step once (a
multiply and an add rounded apart would part from it by up to ~1.5e-5
relative over 128 steps).
"""

import ctypes

import torch

from . import _build
from .rowwise import _raise_on

__all__ = ["FMA_K", "copy3", "copy3_cuda", "fma", "fma_cuda"]

FMA_K = 128  # the chain length of the JAX package's probe
_FMA_A, _FMA_B = 1.0000001, 1e-7


def _copy3_plain(a, b, c):
    """Plain version of copy3: three clones."""
    return tuple(x.clone() for x in (a, b, c))


def _fma_plain(x, k=FMA_K):
    """Plain version of fma: each step ``x * a + b`` rounded once to float32,
    as the kernel's FFMA rounds it -- the product (exact) and the sum in
    float64, the constants float32's."""
    a = float(torch.tensor(_FMA_A, dtype=torch.float32))
    b = float(torch.tensor(_FMA_B, dtype=torch.float32))
    for _ in range(k):
        x = (x.double() * a + b).to(x.dtype)
    return x


def _library():
    lib = _build.load("probes")
    if not getattr(lib, "_odil_typed", False):
        lib.odil_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odil_cuda_error_string.restype = ctypes.c_char_p
        lib.odil_probe_copy3.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
        lib.odil_probe_copy3.restype = ctypes.c_int
        lib.odil_probe_fma.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.odil_probe_fma.restype = ctypes.c_int
        lib._odil_typed = True
    return lib


def _check(ts, what):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the {what} probe takes contiguous float32 CUDA tensors, got {t.dtype} on {t.device}")
    if len({tuple(t.shape) for t in ts}) != 1:
        raise ValueError(f"the {what} probe takes arrays of one shape, got {[tuple(t.shape) for t in ts]}")


def copy3_cuda(a, b, c):
    """CUDA copy3 (replaces the roofline's Pallas ``copy3``): three new
    arrays, on the current stream."""
    _check((a, b, c), "copy3")
    lib = _library()
    outs = tuple(torch.empty_like(x) for x in (a, b, c))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.odil_probe_copy3(*[x.data_ptr() for x in (a, b, c) + outs], a.numel(), stream)
    _raise_on(lib, err, "odil_probe_copy3")
    copy3_cuda.launches += 1
    return outs


copy3_cuda.launches = 0


def fma_cuda(x, k=FMA_K):
    """CUDA fma (replaces the kernel ablation's Pallas ``fma``): a new array,
    on the current stream."""
    _check((x,), "fma")
    if k < 0:
        raise ValueError(f"the fma probe takes k >= 0, got {k}")
    lib = _library()
    y = torch.empty_like(x)
    err = lib.odil_probe_fma(x.data_ptr(), y.data_ptr(), x.numel(), int(k), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "odil_probe_fma")
    fma_cuda.launches += 1
    return y


fma_cuda.launches = 0


def copy3(a, b, c):
    """(a2, b2, c2): copies of three fp32 arrays of one shape."""
    return copy3_cuda(a, b, c) if a.is_cuda else _copy3_plain(a, b, c)


def fma(x, k=FMA_K):
    """k FMA steps on every element of x."""
    return fma_cuda(x, k) if x.is_cuda else _fma_plain(x, k)
