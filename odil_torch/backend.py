"""The NumPy-convention op namespaces (``mod``) handed to user operators.

PyTorch counterpart of ``odil_tpu/backend.py``: ``ModTorch`` is
``ModJax``'s surface on tensors, so that operators written against
``ctx.mod`` (``where``, ``roll``, ``stack``, ``clip``, ``einsum``,
``random.normal``, ...) run unchanged; ``ModNumpy`` is the host-only
namespace for post-processing.  Signatures follow NumPy (``axis=`` rather
than ``dim=``), and so do the results where NumPy and torch part:
``transpose`` without axes reverses them, ``std`` has ddof 0, ``median``
of an even count is the mean of the two middle values, ``min``/``max``/
``argmax``/``argmin`` return values or flat indices, and ``full``,
``ones``, ``arange`` and ``linspace`` (with its endpoint) take their
default dtype as ``jax.numpy`` does: float64 and int64 where 64-bit values
are on (a float64 ``Domain``, or ``ODIL_DTYPE=float64``), else float32 and
int32.  Every tensor that a function makes lies on the mod's device.

``convolution`` and ``conv_transpose`` are ``jax.lax``'s single-channel
N-D cross-correlation and ``conv_transpose`` (channels-last layouts,
``transpose_kernel=False``) through ``torch.nn.functional.conv*``, in full
fp32 (``runtime.pin_fp32``).  ``random`` draws from an explicit
``torch.Generator`` on the mod's device: the same shapes, dtypes, moments
and seed determinism as the JAX package's, not its bits.
"""

from argparse import Namespace

import numpy as np
import torch

__all__ = ["ModBase", "ModNumpy", "ModTorch"]

# The names ModBase forwards from the array namespace (odil_tpu/backend.py).
FORWARDED = (
    "abs", "arange", "arctan2", "argmax", "argmin", "broadcast_to", "clip", "concatenate", "cos", "cosh", "cumsum",
    "einsum", "exp", "floor", "full", "hstack", "linspace", "log", "matmul", "maximum", "mean", "median",
    "meshgrid", "minimum", "moveaxis", "ones", "ones_like", "pad", "reshape", "roll", "sin", "sinh", "sqrt",
    "square", "stack", "std", "sum", "tanh", "transpose", "where", "zeros", "zeros_like",
)


class ModBase:
    """The names shared by both JAX-package mods, over a NumPy-like ``xp``
    (here NumPy, for ``ModNumpy``)."""

    def __init__(self, xp):
        self.xp = xp
        for name in FORWARDED:
            setattr(self, name, getattr(xp, name))
        self.min = xp.min
        self.max = xp.max
        self.flatten = lambda x: xp.reshape(x, (-1,))
        self.relu = lambda x: xp.maximum(x, 0)
        self.sigmoid = lambda x: 1 / (1 + xp.exp(-x))
        self.norm = lambda x: xp.sqrt(xp.sum(xp.square(x)))
        self.mod = xp

    def cast(self, x, dtype):
        return self.xp.asarray(x, dtype=dtype)

    def gather_nd(self, u, idx):
        idx = self.xp.moveaxis(idx, -1, 0)
        return u[tuple(idx[i] for i in range(idx.shape[0]))]

    def split_by_sizes(self, array, sizes, axis=0):
        bounds = np.cumsum(sizes)[:-1]
        return self.xp.split(array, bounds, axis=axis)


class ModNumpy(ModBase):
    """Host-only namespace for post-processing without a device runtime
    (``odil_tpu/backend.py::ModNumpy``)."""

    def __init__(self):
        super().__init__(np)
        self.jax = None
        self.tf = None
        self.modsp = None
        self.array = np.asarray
        self.constant = np.asarray
        self.variable = lambda x, dtype=None: np.asarray(x, dtype=dtype)
        self.copy = np.copy
        self.numpy = np.asarray
        self.native = np.asarray
        self.spnative = lambda x: x
        self.ndarray = np.ndarray
        self.stop_gradient = lambda x: x
        self.is_tensor = lambda x: isinstance(x, np.ndarray)
        self.jit_wrap = lambda **kw: (lambda f: f)

        self.random = Namespace()
        rng = {"rng": np.random.default_rng()}

        def set_seed(seed):
            rng["rng"] = np.random.default_rng(seed)

        self.random.set_seed = set_seed
        self.random.uniform = lambda shape, minval=0.0, maxval=1.0, dtype=None: rng["rng"].uniform(
            minval, maxval, size=shape
        ).astype(dtype or np.float64)
        self.random.normal = lambda shape, mean=0.0, stddev=1.0, dtype=None: rng["rng"].normal(
            mean, stddev, size=shape
        ).astype(dtype or np.float64)

    def convolution(self, input, filters, strides, padding):
        raise NotImplementedError("convolution requires a compute backend (ModTorch)")

    def conv_transpose(self, *args, **kwargs):
        raise NotImplementedError("conv_transpose requires a compute backend (ModTorch)")


def _shape(shape):
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple, range)) else axis


def _xla_same(n, k, s):
    """XLA's SAME padding (lo, hi) of one spatial dimension."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_padding(k, s, padding):
    """``jax.lax.conv_transpose``'s padding of one spatial dimension."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding must be 'SAME', 'VALID' or explicit pairs, got {padding!r}")
    return lo, pad_len - lo


def _conv(x, w, pads, strides=1):
    """Cross-correlation of x (N, C, *spatial) with w (O, C, *kernel) after
    padding each spatial dimension by pads[d] = (lo, hi) (negative crops),
    in full fp32 (``runtime.pin_fp32``)."""
    from .runtime import pin_fp32

    pin_fp32()
    nd = x.ndim - 2
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    if any(flat):
        x = torch.nn.functional.pad(x, flat)
    conv = (torch.nn.functional.conv1d, torch.nn.functional.conv2d, torch.nn.functional.conv3d)[nd - 1]
    return conv(x, w, stride=strides)


class ModTorch:
    """The compute namespace, backed by ``torch``, on ``device``.

    x64: whether 64-bit defaults are on (``jax_enable_x64``); None reads
    ``ODIL_DTYPE`` when a default is taken (a float64 ``Domain`` passes
    True)."""

    def __init__(self, device=None, x64=None):
        self.device = torch.device(device) if device is not None else None
        self._x64 = x64
        self.xp = torch
        self.mod = torch
        self.jax = None
        self.tf = None
        self.numpy = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        self.stop_gradient = lambda x: x.detach()
        self.is_tensor = torch.is_tensor
        self.ndarray = torch.Tensor
        self.native = self.array
        self.constant = self.array
        self.variable = self.array
        self.spnative = lambda x: x
        self.jit_wrap = lambda **kw: (lambda f: f)
        for name in ("cos", "cosh", "exp", "floor", "log", "sin", "sinh", "sqrt", "square", "tanh"):
            setattr(self, name, self._unary(getattr(torch, name)))
        self.flatten = lambda x: torch.reshape(self._t(x), (-1,))
        try:
            import scipy.sparse as modsp
            import scipy.sparse.linalg  # noqa: F401 -- modsp.linalg below
        except ImportError:
            self.modsp = None
        else:
            self.modsp = modsp
            self.csr_matrix = modsp.csr_matrix
            self.diags = modsp.diags
            self.bmat = modsp.bmat
            self.block_diag = modsp.block_diag
            self.tril = modsp.tril
            self.spnorm = modsp.linalg.norm
            self.spsolve = modsp.linalg.spsolve
        self.random = self._make_random()

    # -- Defaults and conversions -------------------------------------------

    @property
    def x64(self):
        if self._x64 is not None:
            return self._x64
        from .runtime import default_dtype

        return default_dtype() == np.float64

    def _float(self):
        return torch.float64 if self.x64 else torch.float32

    def _int(self):
        return torch.int64 if self.x64 else torch.int32

    def _dtype(self, dtype):
        """A numpy, torch or string dtype as a torch dtype (None stays None)."""
        if dtype is None or isinstance(dtype, torch.dtype):
            return dtype
        return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype

    def _canon(self, dtype):
        """``jax.numpy``'s canonical dtype: 64-bit types narrowed without x64."""
        if not self.x64:
            return {torch.float64: torch.float32, torch.int64: torch.int32}.get(dtype, dtype)
        return dtype

    def _t(self, x, dtype=None):
        """``x`` as a tensor (a tensor as it is), on the mod's device for a new
        one; Python and NumPy scalars take ``jax.numpy``'s dtypes."""
        if torch.is_tensor(x):
            return x if dtype is None else x.to(self._dtype(dtype))
        t = torch.as_tensor(np.asarray(x), device=self.device)
        return t.to(self._dtype(dtype) if dtype is not None else self._canon(t.dtype))

    def _pair(self, a, b):
        """Two operands as tensors of one device, a Python scalar taking the
        other's dtype."""
        if torch.is_tensor(a) and not torch.is_tensor(b):
            return a, torch.as_tensor(b, dtype=a.dtype if np.ndim(b) == 0 else None, device=a.device)
        if torch.is_tensor(b) and not torch.is_tensor(a):
            return torch.as_tensor(a, dtype=b.dtype if np.ndim(a) == 0 else None, device=b.device), b
        return self._t(a), self._t(b)

    def _unary(self, fn):
        return lambda x: fn(self._t(x))

    def array(self, x, dtype=None):
        return self._t(x, dtype)

    def copy(self, x):
        return self._t(x).clone()

    def cast(self, x, dtype):
        dt = self._dtype(dtype)
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dt) if self.device is not None else x.to(dtype=dt)
        return torch.as_tensor(np.asarray(x), device=self.device).to(dt)

    # -- Elementwise -----------------------------------------------------------

    def abs(self, x):
        return torch.abs(self._t(x))

    def arctan2(self, x1, x2):
        return torch.atan2(*self._pair(x1, x2))

    def maximum(self, a, b):
        return torch.maximum(*self._pair(a, b))

    def minimum(self, a, b):
        return torch.minimum(*self._pair(a, b))

    def relu(self, x):
        return self.maximum(x, 0)

    def sigmoid(self, x):
        return 1 / (1 + torch.exp(-self._t(x)))

    def clip(self, a, a_min=None, a_max=None, min=None, max=None):
        lo = a_min if a_min is not None else min
        hi = a_max if a_max is not None else max
        a = self._t(a)
        if torch.is_tensor(lo) or torch.is_tensor(hi):
            lo = None if lo is None else self._pair(a, lo)[1]
            hi = None if hi is None else self._pair(a, hi)[1]
        return torch.clamp(a, lo, hi)

    def where(self, cond, a=None, b=None):
        if a is None and b is None:
            return torch.where(self._t(cond))
        a, b = self._pair(a, b)
        return torch.where(self._t(cond), a, b)

    def matmul(self, a, b):
        return torch.matmul(*self._pair(a, b))

    def einsum(self, subscripts, *operands):
        return torch.einsum(subscripts, *[self._t(o) for o in operands])

    # -- Shapes ---------------------------------------------------------------

    def reshape(self, x, shape):
        return torch.reshape(self._t(x), _shape(shape))

    def broadcast_to(self, x, shape):
        return torch.broadcast_to(self._t(x), _shape(shape))

    def transpose(self, x, axes=None):
        x = self._t(x)
        return x.permute(tuple(range(x.ndim - 1, -1, -1)) if axes is None else tuple(axes))

    def moveaxis(self, x, source, destination):
        return torch.movedim(self._t(x), source, destination)

    def roll(self, x, shift, axis=None):
        if isinstance(shift, list):
            shift = tuple(shift)
        x = self._t(x)
        if axis is None:
            return torch.roll(x, shift)
        return torch.roll(x, shift, _axes(axis))

    def stack(self, xs, axis=0):
        return torch.stack([self._t(x) for x in xs], dim=axis)

    def concatenate(self, xs, axis=0):
        xs = [self._t(x) for x in xs]
        if axis is None:
            return torch.cat([x.reshape(-1) for x in xs])
        return torch.cat(xs, dim=axis)

    def hstack(self, xs):
        return torch.hstack([self._t(x) for x in xs])

    def split_by_sizes(self, array, sizes, axis=0):
        return list(torch.split(self._t(array), [int(s) for s in sizes], dim=axis))

    def pad(self, x, pad_width, mode="constant", constant_values=0):
        """``numpy.pad`` for the modes constant, wrap, edge, reflect and
        symmetric (pad widths as an int, a pair, or a pair a dimension)."""
        x = self._t(x)
        widths = np.broadcast_to(np.asarray(pad_width, dtype=int).reshape(-1, 2) if np.ndim(pad_width) else
                                 np.full((1, 2), int(pad_width)), (x.ndim, 2))
        if mode == "constant":
            flat = []
            for lo, hi in reversed(widths.tolist()):
                flat += [lo, hi]
            return torch.nn.functional.pad(x, flat, value=float(constant_values))
        for d, (lo, hi) in enumerate(widths.tolist()):
            n = x.shape[d]
            parts = []
            if mode == "wrap":
                parts = [x.narrow(d, n - lo, lo), x, x.narrow(d, 0, hi)]
            elif mode == "edge":
                parts = [x.narrow(d, 0, 1).repeat_interleave(lo, d), x, x.narrow(d, n - 1, 1).repeat_interleave(hi, d)]
            elif mode == "reflect":
                parts = [x.narrow(d, 1, lo).flip(d), x, x.narrow(d, n - 1 - hi, hi).flip(d)]
            elif mode == "symmetric":
                parts = [x.narrow(d, 0, lo).flip(d), x, x.narrow(d, n - hi, hi).flip(d)]
            else:
                raise ValueError(f"pad: mode {mode!r} is not supported")
            x = torch.cat(parts, dim=d)
        return x

    def gather_nd(self, u, idx):
        idx = torch.movedim(self._t(idx), -1, 0)
        return self._t(u)[tuple(idx[i] for i in range(idx.shape[0]))]

    # -- Reductions -----------------------------------------------------------

    def sum(self, x, axis=None, keepdims=False):
        x = self._t(x)
        return torch.sum(x) if axis is None else torch.sum(x, dim=_axes(axis), keepdim=keepdims)

    def mean(self, x, axis=None, keepdims=False):
        x = self._t(x)
        return torch.mean(x) if axis is None else torch.mean(x, dim=_axes(axis), keepdim=keepdims)

    def std(self, x, axis=None, ddof=0, keepdims=False):
        x = self._t(x)
        if axis is None:
            return torch.std(x, correction=ddof)
        return torch.std(x, dim=_axes(axis), correction=ddof, keepdim=keepdims)

    def median(self, x, axis=None, keepdims=False):
        """The middle value, or the mean of the two middle values of an even
        count (``torch.median`` takes the lower one)."""
        x = self._t(x)
        if axis is None:
            out = self.median(x.reshape(-1), 0)
            return out.reshape((1,) * x.ndim) if keepdims else out
        s = torch.sort(x, dim=axis).values
        n = s.shape[axis]
        out = s.narrow(axis, n // 2, 1) if n % 2 else (s.narrow(axis, n // 2 - 1, 1) + s.narrow(axis, n // 2, 1)) / 2
        return out if keepdims else out.squeeze(axis)

    def min(self, x, axis=None, keepdims=False):
        x = self._t(x)
        return torch.min(x) if axis is None else torch.amin(x, dim=_axes(axis), keepdim=keepdims)

    def max(self, x, axis=None, keepdims=False):
        x = self._t(x)
        return torch.max(x) if axis is None else torch.amax(x, dim=_axes(axis), keepdim=keepdims)

    def argmax(self, x, axis=None):
        return torch.argmax(self._t(x), dim=axis)

    def argmin(self, x, axis=None):
        return torch.argmin(self._t(x), dim=axis)

    def cumsum(self, x, axis=None, dtype=None):
        x = self._t(x)
        if axis is None:
            x, axis = x.reshape(-1), 0
        return torch.cumsum(x, dim=axis, dtype=self._dtype(dtype))

    def norm(self, x):
        return torch.sqrt(torch.sum(torch.square(self._t(x))))

    # -- Constructors ---------------------------------------------------------

    def zeros(self, shape, dtype=None):
        return torch.zeros(_shape(shape), dtype=self._dtype(dtype) or self._float(), device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(_shape(shape), dtype=self._dtype(dtype) or self._float(), device=self.device)

    def zeros_like(self, x, dtype=None):
        return torch.zeros_like(self._t(x), dtype=self._dtype(dtype))

    def ones_like(self, x, dtype=None):
        return torch.ones_like(self._t(x), dtype=self._dtype(dtype))

    def full(self, shape, fill_value, dtype=None):
        dt = self._dtype(dtype)
        if dt is None:
            if torch.is_tensor(fill_value):
                dt = fill_value.dtype
            elif isinstance(fill_value, (bool, np.bool_)):
                dt = torch.bool
            elif isinstance(fill_value, (int, np.integer)):
                dt = self._int()
            else:
                dt = self._float()
        if torch.is_tensor(fill_value):
            return torch.broadcast_to(fill_value.to(dt), _shape(shape)).clone()
        return torch.full(_shape(shape), fill_value, dtype=dt, device=self.device)

    def arange(self, start, stop=None, step=None, dtype=None):
        if stop is None:
            start, stop = 0, start
        step = 1 if step is None else step
        dt = self._dtype(dtype)
        if dt is None:
            ints = all(isinstance(v, (int, np.integer)) for v in (start, stop, step))
            dt = self._int() if ints else self._float()
        return torch.arange(start, stop, step, dtype=dt, device=self.device)

    def linspace(self, start, stop, num=50, endpoint=True, dtype=None):
        dt = self._dtype(dtype) or self._float()
        num = int(num)
        if endpoint:
            return torch.linspace(float(start), float(stop), num, dtype=torch.float64, device=self.device).to(dt)
        return torch.linspace(float(start), float(stop), num + 1, dtype=torch.float64, device=self.device)[:num].to(dt)

    def meshgrid(self, *axes, indexing="xy"):
        return list(torch.meshgrid(*[self._t(a) for a in axes], indexing=indexing))

    # -- Random ---------------------------------------------------------------

    def _make_random(self):
        """``random.set_seed``, ``uniform``, ``normal`` and ``next_key`` on a
        ``torch.Generator`` of the mod's device, seeded from NumPy's entropy
        until ``set_seed``."""
        random = Namespace()
        random._gen = None
        device = self.device or torch.device("cpu")

        def set_seed(seed):
            random._gen = torch.Generator(device=device).manual_seed(int(seed))

        def gen():
            if random._gen is None:
                set_seed(np.random.default_rng().integers(1 << 31))
            return random._gen

        def next_key():
            """A new generator, seeded from the mod's (a split of its key)."""
            seed = int(torch.randint(0, 1 << 62, (1,), generator=gen(), device=device))
            return torch.Generator(device=device).manual_seed(seed)

        def uniform(shape, minval=0.0, maxval=1.0, dtype=None):
            dt = self._dtype(dtype) or torch.float32
            u = torch.rand(_shape(shape), generator=gen(), dtype=dt, device=device)
            return u * (maxval - minval) + minval

        def normal(shape, mean=0.0, stddev=1.0, dtype=None):
            dt = self._dtype(dtype) or torch.float32
            sample = torch.randn(_shape(shape), generator=gen(), dtype=dt, device=device)
            return torch.as_tensor(mean, dtype=dt, device=device) + torch.as_tensor(stddev, dtype=dt,
                                                                                    device=device) * sample

        random.set_seed = set_seed
        random.uniform = uniform
        random.normal = normal
        random.next_key = next_key
        return random

    # -- Convolutions -----------------------------------------------------------

    def convolution(self, input, filters, strides, padding):
        """N-dimensional single-channel cross-correlation
        (``jax.lax.conv_general_dilated`` with one feature in and out):
        ``padding`` "VALID", "SAME" (XLA's: output ceil(n / stride), the odd
        cell at the end) or one (lo, hi) pair a dimension; ``strides`` an int
        or one a dimension.  1 to 3 dimensions."""
        x, w = self._t(input), self._t(filters)
        nd = x.ndim
        if not 1 <= nd <= 3:
            raise ValueError(f"convolution: 1 to 3 dimensions, got {nd}")
        strides = (int(strides),) * nd if np.ndim(strides) == 0 else tuple(int(s) for s in strides)
        if isinstance(padding, str):
            if padding == "VALID":
                pads = [(0, 0)] * nd
            elif padding == "SAME":
                pads = [_xla_same(n, k, s) for n, k, s in zip(x.shape, w.shape, strides)]
            else:
                raise ValueError(f"padding must be 'SAME', 'VALID' or explicit pairs, got {padding!r}")
        else:
            pads = [tuple(p) for p in padding]
        return _conv(x[None, None], w[None, None], pads, strides)[0, 0]

    def conv_transpose(self, input, filters, output_shape=None, strides=None, padding=None):
        """``jax.lax.conv_transpose`` with its defaults: channels-last layouts
        (``NC``/``IO``, ``NHC``/``HIO``, ``NHWC``/``HWIO``, ``NHWDC``/``HWDIO``),
        the kernel not flipped (``transpose_kernel=False``), ``padding``
        "SAME", "VALID" or one (lo, hi) pair a spatial dimension: the input
        dilated by the strides, padded, and cross-correlated with the
        kernel.  ``output_shape`` is not used (nor is it by the JAX
        package)."""
        x, w = self._t(input), self._t(filters)
        nd = x.ndim - 2
        if nd == 0:
            from .runtime import pin_fp32

            pin_fp32()
            return torch.einsum("nc,co->no", x, w)
        if not 1 <= nd <= 3:
            raise ValueError(f"conv_transpose: 1 to 3 spatial dimensions, got {nd}")
        strides = (1,) * nd if strides is None else (
            (int(strides),) * nd if np.ndim(strides) == 0 else tuple(int(s) for s in strides))
        ks = w.shape[:nd]
        if isinstance(padding, str):
            pads = [_transpose_padding(k, s, padding) for k, s in zip(ks, strides)]
        else:
            pads = [tuple(p) for p in padding]
        xc = torch.movedim(x, -1, 1)  # (N, C, *spatial)
        if any(s > 1 for s in strides):
            shape = list(xc.shape[:2]) + [(n - 1) * s + 1 for n, s in zip(xc.shape[2:], strides)]
            dilated = xc.new_zeros(shape)
            dilated[(slice(None), slice(None)) + tuple(slice(None, None, s) for s in strides)] = xc
            xc = dilated
        wc = w.permute((nd + 1, nd) + tuple(range(nd)))  # (O, I, *kernel)
        return torch.movedim(_conv(xc, wc, pads), 1, -1)
