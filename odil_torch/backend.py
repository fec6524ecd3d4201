"""The NumPy-convention op namespace (``mod``) handed to user operators.

PyTorch counterpart of ``odil_tpu/backend.py::ModJax``: operators written
against ``ctx.mod`` (``where``, ``roll``, ``stack``, ...) run unchanged on
tensors.  Signatures follow NumPy (``axis=`` rather than ``dim=``) because
the operators were written for that surface.
"""

import numpy as np
import torch

__all__ = ["ModTorch"]


def _scalar_like(x, ref):
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


class ModTorch:
    """The compute namespace, backed by ``torch``."""

    def __init__(self, device=None):
        self.device = device
        self.xp = torch
        self.numpy = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        self.stop_gradient = lambda x: x.detach()
        self.is_tensor = torch.is_tensor
        for name in ("abs", "cos", "exp", "log", "sin", "sqrt", "square", "tanh", "maximum", "minimum"):
            setattr(self, name, getattr(torch, name))
        self.sigmoid = lambda x: 1 / (1 + torch.exp(-x))

    def where(self, cond, a, b):
        ref = a if torch.is_tensor(a) else b
        return torch.where(cond, _scalar_like(a, ref), _scalar_like(b, ref))

    def roll(self, x, shift, axis):
        if isinstance(axis, range):
            axis = tuple(axis)
        if isinstance(shift, list):
            shift = tuple(shift)
        return torch.roll(x, shift, axis)

    def stack(self, xs, axis=0):
        return torch.stack(list(xs), dim=axis)

    def concatenate(self, xs, axis=0):
        return torch.cat(list(xs), dim=axis)

    def reshape(self, x, shape):
        return torch.reshape(x, tuple(shape))

    def flatten(self, x):
        return torch.reshape(x, (-1,))

    def mean(self, x, axis=None):
        return torch.mean(x) if axis is None else torch.mean(x, dim=axis)

    def sum(self, x, axis=None):
        return torch.sum(x) if axis is None else torch.sum(x, dim=axis)

    def cast(self, x, dtype):
        from .runtime import torch_dtype

        dt = torch_dtype(dtype)
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dt)
        return torch.as_tensor(np.asarray(x), dtype=dt, device=self.device)

    def zeros(self, shape, dtype=None):
        from .runtime import torch_dtype

        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype or np.float32), device=self.device)

    def meshgrid(self, *axes, indexing="ij"):
        ts = [torch.as_tensor(a, device=self.device) for a in axes]
        return torch.meshgrid(*ts, indexing=indexing)

    def pad(self, x, pad_width, mode="constant"):
        assert mode == "constant", mode
        flat = []
        for lo, hi in reversed(pad_width):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat)

    def split_by_sizes(self, array, sizes, axis=0):
        return list(torch.split(array, list(sizes), dim=axis))
