"""Carries state across from the JAX package: numpy arrays to tensors."""

import numpy as np
import torch

from .runtime import torch_dtype

__all__ = ["arrays_from_numpy"]


def arrays_from_numpy(arrays, device="cuda", dtype=None):
    """The port's flat tensor list from the JAX package's
    ``domain.arrays_from_state(state)`` given as numpy arrays (same leaf
    order), on `device`, in `dtype` (default: each array's own)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dt = torch_dtype(dtype) if dtype is not None else torch_dtype(a.dtype)
        out.append(torch.as_tensor(a, device=device).to(dt).contiguous())
    return out
