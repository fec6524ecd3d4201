"""A user's row function as a row model of the tile kernels, on 1-D planes
(``csrc/rows1d.cuh``) or on 2-D planes (``csrc/rows2d.cuh``): traced,
differentiated and turned into CUDA at first use.

The TPU kernels ``_forward``/``_backward``, ``_forward_blocked``/
``_backward_blocked`` and ``_forward_stream``/``_backward_stream``
(``odil_tpu/ops/rowwise.py:132``, ``:185``, ``:322``, ``:396``, ``:616``,
``:690``) and the x-tiled pair of ``odil_tpu/ops/rowwise_tiled.py`` take any
row function: Pallas traces it into the kernel's body and ``jax.vjp``
differentiates it there.  CUDA has no autodiff, so for a row function that
names no CUDA model (``RowModel.cuda_model is None``) on (T, N) or (T, X, Y)
planes this module does both ahead of the build; the kernel skeleton stays
hand-written (``rows1d_kernel``, ``rows2d_kernel``), and only the per-cell
body is generated:

1. ``trace``: the row function runs once on symbolic values, one per cell,
   that stand for its stacks (``rows[f][m]``, the data rows, the consts, the
   params, ``it`` and ``T``) and take the torch operations of the row
   functions of this repository through ``__torch_function__``: ``+ - * /``,
   ``neg``, ``pow`` by a constant, ``tanh``, ``exp``, ``log``, ``sqrt``,
   ``rsqrt``, ``sigmoid``, ``abs``, ``minimum``/``maximum``, ``where``,
   comparisons and ``&``/``|``/``~``, ``detach``, ``torch.roll`` along the
   plane's axes (an axis of a value counted from its last: on a (R, X, Y)
   stack dims -2 and -1, on an (X, Y) const plane dims 0 and 1; tuple shifts
   and dims too) and the elements of params (``w[o, i]``).  The result is a
   scalar SSA program over the samples of the fields at the offsets -1, 0, 1
   along each plane axis (a roll moves the reads of what it rolls:
   ``roll(v, s)`` at x is v at x - s), the data and consts read at any
   offset with the plane's wrap, and the params.  Values are hash-consed,
   so equal expressions are one value.  A function outside the set or the
   kernels' limits (1-D: 2 fields and hist 4; 2-D: 3 fields, hist 2 and a
   block's shared memory within 227 KB; both: 2 data, 6 consts, 8 param
   tensors of 48 elements in all, fields read at ±1 along each axis) raises
   ``Refused`` with the reason, before anything is built.
2. ``_adjoint``: reverse mode over the program with torch autograd's rules
   (``detach`` and comparisons give no gradient, ``where`` passes it to the
   chosen branch, ``minimum``/``maximum`` split it at ties, ``abs`` gives 0
   at 0), seeded with ``g2[k] * res[k]``, the cotangents of
   ``sum_k g2[k]/2 res[k]^2``: ``D[m][f][q]`` (1-D) or ``D[m][f][qx][qy]``
   (2-D) of the samples and ``pacc[p]`` of the params.
3. ``Trace.source``: a ``.cu`` unit whose row model struct has the
   ``rows1d.cuh`` or the ``rows2d.cuh`` interface (its param cotangents go
   into the kernel's registers, owned cells only) and that exports the
   ``odil_rows1d_*`` or ``odil_rows2d_*`` entry points for model id 0, the
   masked per-shard pair (``*_halo_*``) among them, as ``heat_net.cu`` does
   for heat.  On a masked launch ``it`` and ``T`` are the global row and row
   count.  Literals are exact fp32 hex floats.  ``ops/rowwise.py`` builds it
   with ``_build.compile_generated`` at first use (one library per source,
   keyed on its digest).  On 2-D planes ``Trace.mg_source`` is the same row
   model in a unit of the multigrid-fused walk (``csrc/mg_rows2d.cuh``, the
   ``odil_mg2d_*`` entry points), which ``ops/rowwise_mg.py`` builds apart
   at first use.

The function's fp32 operations per cell (``ops_forward``, ``ops_backward``:
a transcendental as one, a sigmoid as three; an expression that the body
computes at two shifts, as heat's conductivity net at both faces of a cell,
counted once) give the kernels' bound.
"""

import functools
import struct
import types

import numpy as np
import torch

__all__ = ["Refused", "Trace", "fingerprint", "trace"]

# The kernels' limits (csrc/rows1d.cuh, csrc/rows2d.cuh: MAXF, MAXD, MAXC,
# MAXP; the register param form of at most 48 cotangents a thread), by the
# plane's rank where they differ; SMEM_LIMIT the shared memory of a block.
MAX_FIELDS, MAX_DATA, MAX_CONSTS, MAX_PARAM_TENSORS, MAX_PARAMS = {1: 2, 2: 3}, 2, 6, 8, 48
MAX_TERMS, MAX_HIST, REACH = 8, {1: 4, 2: 2}, 1
SMEM_LIMIT = 232448

_F, _I, _B = "float", "int", "bool"


class Refused(Exception):
    """A row function that the traced kernels do not take; ``str`` is the
    reason."""


class _Node:
    __slots__ = ("op", "args", "dtype", "xdep", "index")

    def __init__(self, op, args, dtype, xdep, index):
        self.op, self.args, self.dtype, self.xdep, self.index = op, args, dtype, xdep, index


class _Graph:
    """The SSA program: nodes in creation order (a topological order),
    hash-consed on (op, dtype, arguments)."""

    def __init__(self):
        self.nodes, self._keys, self._shifts = [], {}, {}

    def make(self, op, args, dtype, xdep=None):
        key = (op, dtype) + tuple(("n", a.index) if isinstance(a, _Node) else a for a in args)
        node = self._keys.get(key)
        if node is None:
            if xdep is None:
                xdep = any(a.xdep for a in args if isinstance(a, _Node))
            node = _Node(op, tuple(args), dtype, xdep, len(self.nodes))
            self.nodes.append(node)
            self._keys[key] = node
        return node

    def lit(self, value, dtype):
        if dtype == _F:
            return self.make("lit", (_f32_bits(value),), _F, False)
        if dtype == _I:
            value = int(value)
            if not -(2**31) <= value < 2**31:
                raise Refused(f"the integer literal {value} does not fit the kernels' 32-bit int")
            return self.make("lit", (value,), _I, False)
        return self.make("lit", (bool(value),), _B, False)

    def shift(self, node, d):
        """``node`` at the plane position + d (an offset along each axis)."""
        if not any(d) or not node.xdep:
            return node
        key = (node.index, d)
        out = self._shifts.get(key)
        if out is None:
            if node.op in ("field", "data", "const"):
                out = self.make(node.op, node.args[:-1] + (_plus(node.args[-1], d),), node.dtype, True)
            else:
                out = self.make(node.op, tuple(self.shift(a, d) if isinstance(a, _Node) else a for a in node.args),
                                node.dtype)
            self._shifts[key] = out
        return out


def _plus(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _minus(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _f32_bits(value):
    return struct.unpack("<I", struct.pack("<f", float(value)))[0]


def _f32_of(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _float_literal(bits):
    v = _f32_of(bits)
    if v != v or v in (float("inf"), float("-inf")):
        return f"__int_as_float({bits if bits < 2**31 else bits - 2**32})"
    text = float.hex(v) + "f"
    return f"({text})" if v < 0 or text.startswith("-") else text


# -- The symbolic values the row function sees ----------------------------------


class _Sym:
    """A traced value: one cell of a stack (``ndim`` the stack's), or a
    scalar.  Operations build nodes of the tracer's graph."""

    __slots__ = ("tracer", "node", "ndim")
    __hash__ = object.__hash__

    def __init__(self, tracer, node, ndim):
        self.tracer, self.node, self.ndim = tracer, node, ndim

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        tracer = next(a.tracer for a in _flat(args, kwargs) if isinstance(a, (_Sym, _SymParam)))
        return tracer.torch_call(func, args, kwargs or {})

    @property
    def dtype(self):
        return {_F: torch.float32, _I: torch.int64, _B: torch.bool}[self.node.dtype]

    def __bool__(self):
        raise Refused("a Python branch on a traced value (bool() of a tensor)")

    def __float__(self):
        raise Refused("a traced value read on the host (float() of a tensor)")

    __int__ = __index__ = item = tolist = numpy = __float__

    def __len__(self):
        raise Refused("len() of a traced stack: the traced kernels give the row function one cell")

    def __iter__(self):
        raise Refused("iteration over a traced stack: the traced kernels give the row function one cell")

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        if self.node.op != "const" or self.node.xdep:
            raise Refused(f"indexing a stack or a plane ({index}): only params and scalar consts are indexed")
        if not all(isinstance(i, int) and i in (0, -1) for i in index) or len(index) > self.ndim:
            raise Refused(f"the index {index} of a scalar const")
        return _Sym(self.tracer, self.node, self.ndim - len(index))

    def __getattr__(self, name):
        return _method(self, name)


class _SymParam:
    """A param tensor (or a part of it): its elements are scalar param
    reads, ``w[o, i]``."""

    __slots__ = ("tracer", "base", "shape")

    def __init__(self, tracer, base, shape):
        self.tracer, self.base, self.shape = tracer, base, tuple(shape)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _Sym.__torch_function__(func, types, args, kwargs)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return torch.float32

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        if len(index) > len(self.shape) or not all(isinstance(i, int) and not isinstance(i, bool) for i in index):
            raise Refused(f"the index {index} of a param of shape {self.shape}: params are read element by element")
        base, stride = self.base, self.numel()
        for i, n in zip(index, self.shape):
            if not -n <= i < n:
                raise Refused(f"the index {index} is out of a param of shape {self.shape}")
            stride //= n
            base += (i % n) * stride
        rest = self.shape[len(index):]
        if rest:
            return _SymParam(self.tracer, base, rest)
        return _Sym(self.tracer, self.tracer.graph.make("param", (base,), _F, False), 0)

    def __bool__(self):
        raise Refused("a Python branch on a traced param")

    def __getattr__(self, name):
        return _method(self, name)


def _method(value, name):
    """A traced value's tensor method ``name`` (an AttributeError for the
    others, which ``trace`` reports as the refusal's reason)."""
    op = _METHODS.get(name)
    if op is None:
        raise AttributeError(f"the tensor attribute or method {name!r} is outside the traced set")
    return lambda *a, **k: value.tracer.call(op, (value,) + a, k)


def _flat(args, kwargs):
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, (tuple, list)):
            yield from a
        else:
            yield a


# Python's operators -> (the tracer's operation, whether the operands
# swap): a traced value's own and torch's (``__torch_function__``).
_DUNDER = {
    "__add__": ("add", False), "__radd__": ("add", True), "__sub__": ("sub", False), "__rsub__": ("sub", True),
    "__mul__": ("mul", False), "__rmul__": ("mul", True), "__truediv__": ("div", False), "__div__": ("div", False),
    "__rtruediv__": ("rdiv", False), "__rdiv__": ("rdiv", False), "__pow__": ("pow", False), "__eq__": ("eq", False),
    "__ne__": ("ne", False), "__lt__": ("lt", False), "__le__": ("le", False), "__gt__": ("gt", False),
    "__ge__": ("ge", False), "__and__": ("and", False), "__rand__": ("and", True), "__or__": ("or", False),
    "__ror__": ("or", True), "__neg__": ("neg", False), "__pos__": ("pos", False), "__abs__": ("abs", False),
    "__invert__": ("not", False),
}


def _dunder(op, swap):
    if op in ("neg", "pos", "abs", "not"):
        return lambda self: self.tracer.call(op, (self,), {})
    return lambda self, other: self.tracer.call(op, (other, self) if swap else (self, other), {})


for _name, (_op, _swap) in _DUNDER.items():
    setattr(_Sym, _name, _dunder(_op, _swap))
    setattr(_SymParam, _name, _dunder(_op, _swap))

# Tensor methods and torch functions by name -> the tracer's operation.
_METHODS = {
    "detach": "detach", "tanh": "tanh", "exp": "exp", "log": "log", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "sigmoid": "sigmoid", "abs": "abs", "neg": "neg", "negative": "neg", "reciprocal": "recip", "square": "square",
    "pow": "pow", "minimum": "min", "maximum": "max", "roll": "roll", "float": "float", "to": "to", "clone": "pos",
    "contiguous": "pos", "add": "add", "sub": "sub", "mul": "mul", "div": "div", "true_divide": "div", "eq": "eq",
    "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "logical_and": "and", "logical_or": "or",
    "logical_not": "not", "where": "where", "zeros_like": "zeros_like", "ones_like": "ones_like",
    "full_like": "full_like", "expit": "sigmoid", "min": "min", "max": "max",
}

# fp32 operations of an operation's forward (a transcendental as one, a
# sigmoid as three: exp, add, div).
_FORWARD_OPS = {"add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "recip": 1, "tanh": 1, "exp": 1, "log": 1,
                "sqrt": 1, "rsqrt": 1, "sigmoid": 3, "abs": 1, "min": 1, "max": 1}


class _Tracer:
    """Runs a row function on symbolic values and records its graph."""

    def __init__(self, rank=1):
        self.graph = _Graph()
        self.rank = rank

    def sym(self, node, ndim):
        return _Sym(self, node, ndim)

    def lift(self, x):
        """(node, ndim) of an operand: a traced value, a param of one
        element, a Python or numpy number.  A tensor or array that the row
        function captures is refused: its value can change between calls,
        and a literal would keep the first."""
        g = self.graph
        if isinstance(x, _Sym):
            return x.node, x.ndim
        if isinstance(x, _SymParam):
            if x.numel() != 1:
                raise Refused(f"a param of shape {x.shape} used whole: params are read element by element")
            return g.make("param", (x.base,), _F, False), x.ndim
        if isinstance(x, bool):
            return g.lit(x, _B), 0
        if isinstance(x, int):
            return g.lit(x, _I), 0
        if isinstance(x, float):
            return g.lit(x, _F), 0
        if isinstance(x, np.generic):
            return self.lift(x.item())
        if isinstance(x, (torch.Tensor, np.ndarray)):
            raise Refused(f"a {type(x).__name__} of shape {tuple(x.shape)} captured by the row function: pass it as "
                          f"data or a const")
        raise Refused(f"an operand of type {type(x).__name__} in the row function")

    def cast(self, node, dtype):
        if node.dtype == dtype:
            return node
        if node.op == "lit":
            v = _f32_of(node.args[0]) if node.dtype == _F else node.args[0]
            return self.graph.lit(v, dtype)
        if dtype == _F:
            return self.graph.make("tof", (node,), _F)
        if dtype == _I and node.dtype == _B:
            return self.graph.make("toi", (node,), _I)
        raise Refused(f"a {node.dtype} value cast to {dtype}")

    def torch_call(self, func, args, kwargs):
        name = getattr(func, "__name__", "")
        if name in _DUNDER:
            op, swap = _DUNDER[name]
            args = tuple(args)
            if swap:
                args = args[::-1]
            return self.call(op, args, kwargs)
        op = _METHODS.get(name)
        if op is None:
            raise Refused(f"torch.{name} is outside the traced set")
        return self.call(op, args, kwargs)

    def call(self, op, args, kwargs):
        g = self.graph
        if op == "roll":
            return self.roll(*args, **kwargs)
        if op in ("to", "float"):
            dtype = args[1] if len(args) > 1 else kwargs.get("dtype", torch.float32)
            if op == "float" or dtype in (torch.float32, torch.float):
                node, ndim = self.lift(args[0])
                return self.sym(self.cast(node, _F), ndim)
            raise Refused(f".to({dtype}): the traced kernels compute in float32")
        if op in ("zeros_like", "ones_like", "full_like"):
            node, ndim = self.lift(args[0])
            value = {"zeros_like": 0.0, "ones_like": 1.0}.get(op)
            if value is None:
                value = args[1] if len(args) > 1 else kwargs["fill_value"]
            return self.sym(g.lit(value, _F), ndim)
        if kwargs:
            raise Refused(f"{op} with the arguments {sorted(kwargs)}")
        if op == "where":
            if len(args) != 3:
                raise Refused("torch.where with one argument")
            (c, nc), (a, na), (b, nb) = (self.lift(x) for x in args)
            if c.dtype != _B:
                raise Refused("torch.where on a condition that is not boolean")
            dtype = _F if _F in (a.dtype, b.dtype) else _I if _I in (a.dtype, b.dtype) else _B
            return self.sym(g.make("where", (c, self.cast(a, dtype), self.cast(b, dtype)), dtype), max(nc, na, nb))
        if op in ("min", "max") and len(args) != 2:
            raise Refused(f"torch.{op} over an axis: only the elementwise form of two tensors is traced")
        if op == "pow":
            return self.pow(*args)
        if op == "square":
            return self.pow(args[0], 2)
        if op == "rdiv":  # Tensor.__rtruediv__: self.reciprocal() * other
            a, na = self.lift(args[0])
            recip = g.make("recip", (self.cast(a, _F),), _F)
            return self.call("mul", (self.sym(recip, na), args[1]), {})
        operands = [self.lift(x) for x in args]
        ndim = max(n for _, n in operands)
        nodes = [n for n, _ in operands]
        if op == "pos":
            return self.sym(nodes[0], ndim)
        if op == "detach":
            a = nodes[0]
            return self.sym(g.make("detach", (a,), _F) if a.dtype == _F else a, ndim)
        if op in ("and", "or", "not"):
            if any(n.dtype != _B for n in nodes):
                raise Refused(f"'{op}' of values that are not boolean")
            return self.sym(g.make(op, tuple(nodes), _B), ndim)
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            dtype = _F if any(n.dtype == _F for n in nodes) else _I
            return self.sym(g.make(op, tuple(self.cast(n, dtype) for n in nodes), _B), ndim)
        if op in ("neg", "abs"):
            a = nodes[0]
            if a.dtype == _B:
                raise Refused(f"'{op}' of a boolean value")
            return self.sym(g.make(op, (a,), a.dtype), ndim)
        if op in ("tanh", "exp", "log", "sqrt", "rsqrt", "sigmoid", "recip"):
            return self.sym(g.make(op, (self.cast(nodes[0], _F),), _F), ndim)
        if op in ("add", "sub", "mul", "div", "min", "max"):
            if len(nodes) != 2:
                raise Refused(f"'{op}' with {len(nodes)} operands")
            dtype = _F if op == "div" or any(n.dtype == _F for n in nodes) else _I
            return self.sym(g.make(op, tuple(self.cast(n, dtype) for n in nodes), dtype), ndim)
        raise Refused(f"the operation {op!r} is outside the traced set")

    def pow(self, base, exponent):
        if isinstance(exponent, (_Sym, _SymParam, torch.Tensor)):
            raise Refused("pow by a traced value: only a constant exponent is traced")
        if not isinstance(base, (_Sym, _SymParam)):
            raise Refused("a constant raised to a traced power")
        a, ndim = self.lift(base)
        if a.dtype != _F:
            raise Refused("pow of an integer value")
        e = float(exponent)
        return self.sym(self.graph.make("pow", (a, _f32_bits(e)), _F), ndim)

    def roll(self, x, shifts, dims=None):
        if dims is None:
            raise Refused("torch.roll without dims flattens the stack")
        shifts = shifts if isinstance(shifts, (tuple, list)) else (shifts,)
        dims = dims if isinstance(dims, (tuple, list)) else (dims,)
        node, ndim = self.lift(x)
        if len(shifts) != len(dims):
            raise Refused("torch.roll with shifts and dims of other lengths")
        d = [0] * self.rank
        for s, axis in zip(shifts, dims):
            if not isinstance(s, int) or isinstance(s, bool):
                raise Refused("torch.roll by a traced or non-integer shift")
            # The plane's axes are the value's last `rank` axes.
            p = axis % ndim - (ndim - self.rank) if ndim else -1
            if not 0 <= p < self.rank:
                which = ("the plane axis (the last) is" if self.rank == 1
                         else f"the plane's axes (the last {self.rank}) are")
                raise Refused(f"torch.roll along axis {axis} of a {ndim}-D stack: only {which} traced")
            d[p] -= s  # roll(v, s) at x is v at x - s
        return self.sym(self.graph.shift(node, tuple(d)), ndim)


# -- The trace -------------------------------------------------------------------


def fingerprint(fn):
    """A hashable key of a row function as the tracer sees it: its code and
    the values it closes over, takes as defaults or reads as globals
    (recursively through functions; modules by name, their attributes taken
    as fixed), or None where one of them is not a plain value (a tensor, an
    object): such a function is traced at every call.  Two functions of one
    key trace to the same program, so a model built anew every epoch (heat's
    operator) is traced once."""
    seen = set()

    def code_names(code):
        names = set(code.co_names)
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                names |= code_names(c)
        return names

    def key(v):
        if isinstance(v, float):  # by its bits: -0.0 and 0.0 trace to other literals
            return ("float", float.hex(v))
        if v is None or isinstance(v, (bool, int, str, complex, types.BuiltinFunctionType)):
            return (type(v).__name__, v)
        if isinstance(v, np.generic):
            return (type(v).__name__, v.item())
        if isinstance(v, (tuple, list, frozenset)):
            parts = tuple(key(x) for x in v)
            return None if None in parts else (type(v).__name__, parts)
        if isinstance(v, types.ModuleType):
            return ("module", v.__name__)
        if isinstance(v, type):
            return ("type", v.__module__, v.__qualname__)
        if isinstance(v, types.FunctionType):
            if id(v) in seen:
                return ("function", v.__code__)
            seen.add(id(v))
            cells = tuple(key(c.cell_contents) for c in v.__closure__ or ())
            defaults = key(tuple(v.__defaults__ or ()) + tuple(sorted((v.__kwdefaults__ or {}).items())))
            glob = tuple(key(v.__globals__[n]) for n in sorted(code_names(v.__code__)) if n in v.__globals__)
            if None in cells or defaults is None or None in glob:
                return None
            return ("function", v.__code__, cells, defaults, glob)
        return None

    try:
        return key(fn)
    except ValueError:  # an empty closure cell
        return None


class Trace:
    """A traced row function: its program, adjoint and CUDA source.

    rank: the plane's (1: (T, N), 2: (T, X, Y)); nterms, hist, nfields: the
    call's; data: per data, whether it is a plane ((T, N) or (T, X, Y), else
    (T, 1) or (T, 1, 1)); consts: per const, (whether it is a plane (else a
    scalar of one element), its ndim); param_shapes; nparams: their
    elements; dused: the D entries its adjoint writes (a mask of the entries
    (m * NF + f) * 3 + q on 1-D planes, ((m * NF + f) * 3 + qx) * 3 + qy on
    2-D ones); body: the row model struct (``TracedRow``); source: the .cu
    unit; ops_forward, ops_backward: the function's fp32 operations per
    residual cell (each shift class once, ``_shift_classes``);
    blocks_per_sm; smem: the dynamic shared memory of the 2-D kernels'
    forward and backward blocks (``csrc/rows2d.cuh``), or None."""

    def __init__(self, nterms, hist, nfields, data, consts, param_shapes, graph, outputs, name, rank=1):
        self.rank = rank
        self.nterms, self.hist, self.nfields = nterms, hist, nfields
        self.data, self.consts, self.param_shapes = tuple(data), tuple(consts), tuple(param_shapes)
        self.nparams = sum(_numel(s) for s in param_shapes)
        self.name = name
        self._graph, self._outputs = graph, outputs
        self.body, self.dused, self.ops_forward, self.ops_backward = _generate(self)
        if rank == 1:
            # Param cotangents in registers (up to 48) and a net's
            # activations kept for its adjoint: one block an SM past 16
            # params (the heat net's register form, heat_row.cuh), two with
            # a few, four without (wave_row.cuh).
            self.smem = None
            self.blocks_per_sm = 1 if self.nparams > 16 else 2 if self.nparams else 4
        else:
            # The blocks whose shared memory an SM holds (228 KB, 1 KB of it
            # reserved a block), one past 16 params.
            self.smem = tuple(rows2d_smem(nfields, hist, nterms, self.nparams, _staged(self.dused), grads)
                              for grads in (False, True))
            fit = SM_SMEM // (self.smem[1] + 1024)
            self.blocks_per_sm = max(1, min(fit, 1 if self.nparams > 16 else 2))
        self.body = self.body.replace("@BLOCKS_PER_SM@", str(self.blocks_per_sm))
        self.source = _unit(self)

    @property
    def nstaged(self):
        """The D entries that the 2-D kernels stage in shared memory."""
        return _staged(self.dused)

    @functools.cached_property
    def mg_source(self):
        """The .cu unit of the multigrid-fused walk over this 2-D row model
        (``csrc/mg_rows2d.cuh``; the ``odil_mg2d_*`` entry points), made
        once: every mg launch looks its library up by it."""
        assert self.rank == 2, "the mg walk takes 2-D planes"
        return _unit_mg(self)


# The shared memory of an SM (H100: 228 KB, of which a block takes at most
# SMEM_LIMIT).
SM_SMEM = 233472
# rows2d.cuh's tile: 16 x 32 cells, a window of halo 2 (20 x 40 floats a
# plane row, the owned columns at 4), the ring-1 positions 18 x 34, a ring of
# HIST + 4 fine rows, 8 warps.
_R2_HX, _R2_HY, _R2_RX, _R2_RY, _R2_HYS, _R2_WARPS, _R2_AHEAD = 20, 40, 18, 34, 36, 8, 3


def _staged(dused):
    """The D entries of a 2-D trace that the kernel stages in shared memory:
    those it uses at a nonzero offset (entry e at offset (0, 0) is e % 9 ==
    4)."""
    return sum(1 for e in range(dused.bit_length()) if (dused >> e) & 1 and e % 9 != 4)


def rows2d_smem(nfields, hist, nterms, nparams, nstaged, grads):
    """The bytes of ``rows2d.cuh``'s ``Smem<M, GRADS>`` (its layout: the
    ring, the staged D planes, the params, the fp64 warp sums, the index
    tables)."""
    ring = (hist + _R2_AHEAD + 1) * nfields * _R2_HX * _R2_HY
    staged = (max(nstaged, 1) * _R2_RX * _R2_RY) if grads else 1
    size = 4 * (ring + staged + max(nparams, 1))
    size = -(-size // 8) * 8
    size += 8 * _R2_WARPS * (-(-(nterms + max(nparams, 1)) // 16) * 16)
    size += 4 * (_R2_HX + _R2_HYS)
    return -(-size // 8) * 8


# mg_rows2d.cuh's walk: a rebuilt row's window of 20 x 36 cells, the coarse
# window of 12 x 20 (level 2: 8 x 12), a dP window of 10 x 18 cells and a ring
# of 4 closed coarse rows.
_MG_HX, _MG_HY, _MG_WX, _MG_WY, _MG_WX2, _MG_WY2, _MG_DWB, _MG_DPR = 20, 36, 12, 20, 8, 12, 18, 4
MG_FORMS = ("whole", "lvl2", "local")


def mg2d_smem(nfields, hist, nterms, nparams, nstaged, grads, form="whole"):
    """The bytes of ``mg_rows2d.cuh``'s ``Smem<M, GRADS, LVL2>`` (its
    layout: the fp64 warp sums, the ring of HIST + 1 rebuilt rows, the staged
    D planes, the params, the rebuild's stage, the level-1 stage at depth 2
    and the dP stage with the gradients; an unused stage takes one float)."""
    assert form in MG_FORMS, form
    size = 8 * _R2_WARPS * (-(-(nterms + max(nparams, 1)) // 16) * 16)
    floats = (hist + 1) * nfields * _MG_HX * _MG_HY
    floats += (max(nstaged, 1) * _R2_RX * _R2_RY) if grads else 1
    floats += max(nparams, 1)
    floats += nfields * _MG_WX * _MG_WY + 2 * 2 * _MG_HX + 2 * 2 * _MG_HY + _MG_HX + _MG_HY
    if form == "lvl2":
        floats += 2 * nfields * _MG_WX * _MG_WY + nfields * _MG_WX2 * _MG_WY2 + 2 * 2 * _MG_WX + 2 * 2 * _MG_WY
    else:
        floats += 1
    if grads:
        floats += nfields * 16 * 32 + _MG_DPR * nfields * 16 * _MG_DWB + 32 * 3 + 16 * 3
    else:
        floats += 1
    size += 4 * floats
    return -(-size // 8) * 8


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def trace(row_fn, nterms, hist, nfields, data, consts, param_shapes, rank=1):
    """The ``Trace`` of ``row_fn(it, T, rows, data_rows, params, consts)``
    on planes of ``rank`` axes for ``nfields`` fields with ``hist`` rows
    back, data of kinds ``data`` (True: a (T, *plane) plane, False: (T, 1)
    or (T, 1, 1)), consts of kinds ``consts`` ((True, ndim): a plane, (N,) or
    (1, N) on 1-D planes, (X, Y) on 2-D ones; (False, ndim): one element)
    and params of ``param_shapes``.  Raises ``Refused`` with the reason
    where the traced kernels do not take it."""
    limits = [
        (nfields, MAX_FIELDS[rank], "fields"), (len(data), MAX_DATA, "data"), (len(consts), MAX_CONSTS, "consts"),
        (len(param_shapes), MAX_PARAM_TENSORS, "param tensors"), (nterms, MAX_TERMS, "terms"),
        (hist, MAX_HIST[rank], "rows back (hist)"),
    ]
    for n, limit, what in limits:
        if n > limit:
            raise Refused(f"{n} {what}: the traced kernels on {rank}-D planes take at most {limit}")
    nparams = sum(_numel(s) for s in param_shapes)
    if nparams > MAX_PARAMS:
        raise Refused(f"{nparams} param elements: the traced kernels keep at most {MAX_PARAMS} param cotangents in "
                      f"registers")
    if nterms < 1 or nfields < 1:
        raise Refused("no terms or no fields")
    tracer = _Tracer(rank)
    g = tracer.graph
    zero = (0,) * rank
    rows = tuple(tuple(tracer.sym(g.make("field", (f, m, zero), _F, True), rank + 1) for m in range(hist + 1))
                 for f in range(nfields))
    data_rows = tuple(tracer.sym(g.make("data", (d, zero), _F, bool(plane)), rank + 1)
                      for d, plane in enumerate(data))
    const_syms = [tracer.sym(g.make("const", (c, zero), _F, plane), ndim) for c, (plane, ndim) in enumerate(consts)]
    params, base = [], 0
    for shape in param_shapes:
        params.append(_SymParam(tracer, base, shape))
        base += _numel(shape)
    it = tracer.sym(g.make("it", (), _I, False), rank + 1)
    T = tracer.sym(g.make("T", (), _I, False), 0)
    try:
        res = row_fn(it, T, rows, data_rows, tuple(params), tuple(const_syms))
    except Refused:
        raise
    except Exception as e:  # the row function took a path the tracer does not give it
        raise Refused(f"the row function failed under the tracer: {type(e).__name__}: {e}") from None
    if not isinstance(res, (tuple, list)) or len(res) != nterms:
        raise Refused(f"the row function returned {len(res) if isinstance(res, (tuple, list)) else res!r} terms, "
                      f"not the call's {nterms}")
    outputs = [tracer.cast(tracer.lift(r)[0], _F) for r in res]
    for node in _reachable(g, outputs):
        if node.op == "field":
            for axis, d in zip("xy", node.args[2]):
                if abs(d) > REACH:
                    raise Refused(f"a field read at {axis}{d:+d}: the kernels' reach is -1 .. +1 along each plane "
                                  f"axis")
    name = f"{getattr(row_fn, '__module__', '?')}.{getattr(row_fn, '__qualname__', repr(row_fn))}"
    tr = Trace(nterms, hist, nfields, data, consts, param_shapes, g, outputs, name, rank)
    if tr.smem is not None and tr.smem[1] > SMEM_LIMIT:
        raise Refused(f"a block of the 2-D kernels needs {tr.smem[1]} bytes of shared memory (a ring of {hist + 4} "
                      f"rows of {nfields} fields and {_staged(tr.dused)} staged cotangent planes), over the "
                      f"{SMEM_LIMIT} bytes a block may take")
    return tr


def _reachable(graph, outputs):
    """The nodes the outputs reach, in creation order."""
    seen = set()
    stack = list(outputs)
    while stack:
        n = stack.pop()
        if n.index in seen:
            continue
        seen.add(n.index)
        stack.extend(a for a in n.args if isinstance(a, _Node))
    return [n for n in graph.nodes if n.index in seen]


# -- The code generator ------------------------------------------------------------

_CTYPE = {_F: "float", _I: "int", _B: "bool"}
_BINARY = {"add": "+", "sub": "-", "mul": "*", "div": "/", "eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
           "ge": ">=", "and": "&&", "or": "||"}
_UNARY = {"tanh": "tanhf", "exp": "expf", "log": "logf", "sqrt": "sqrtf", "rsqrt": "rsqrtf", "abs": "fabsf"}


def _pow_expr(a, e):
    """(C expression, fp32 operations) of a ** e as torch computes it
    (pow_tensor_scalar_optimized_kernel: 2, 3, 0.5, -0.5, -1 and -2 are
    products, roots and reciprocals)."""
    special = {2.0: (f"({a} * {a})", 1), 3.0: (f"({a} * {a} * {a})", 2), 0.5: (f"sqrtf({a})", 1),
               -0.5: (f"rsqrtf({a})", 1), -1.0: (f"(1.0f / {a})", 1), -2.0: (f"(1.0f / ({a} * {a}))", 2),
               1.0: (a, 0), 0.0: ("1.0f", 0)}
    if e in special:
        return special[e]
    return f"powf({a}, {_float_literal(_f32_bits(e))})", 1


_COMMUTATIVE = {"add", "mul", "min", "max", "eq", "ne", "and", "or"}


def _shift_classes(nodes):
    """{node index: its class}: the nodes that are one expression at other
    shifts over the plane, up to the order of a commutative operation's
    operands, share a class (a net at the faces x-1/2 and x+1/2 of a cell:
    the x+1/2 one is its right neighbour's x-1/2 one).  The body computes
    each member; the function needs a class once per cell, so the operation
    counts take each class once."""
    ids, canon = {}, {}  # {key: class}, {index: (class, offset of the expression's reads or None)}
    for n in nodes:
        if not n.xdep:
            key, ref = ("node", n.index), None
        elif n.op in ("field", "data", "const"):
            key, ref = (n.op,) + n.args[:-1], n.args[-1]
        else:
            kids = [canon[a.index] if isinstance(a, _Node) else (("arg", a), None) for a in n.args]
            forms = []
            for order in (kids, kids[::-1]) if n.op in _COMMUTATIVE else (kids,):
                ref = next(off for _, off in order if off is not None)
                forms.append(((n.op, n.dtype) + tuple((c, "-" if off is None else _minus(off, ref))
                                                      for c, off in order), ref))
            key, ref = min(forms, key=lambda form: repr(form[0]))
        canon[n.index] = (ids.setdefault(key, len(ids)), ref)
    return {i: c for i, (c, _) in canon.items()}


def _node_ops(n):
    """fp32 operations of a node's forward."""
    if n.dtype != _F:
        return 0
    if n.op == "pow":
        return _pow_expr("a", _f32_of(n.args[1]))[1]
    return _FORWARD_OPS.get(n.op, 0)


def _sample(m, f, off):
    """The index of a field sample in ``v`` and ``D``: ``[m][f][q...]``, q
    the offset + 1 along each plane axis."""
    return f"[{m}][{f}]" + "".join(f"[{d + 1}]" for d in off)


def _entry(nfields, m, f, off):
    """A sample's bit in DUSED: (m * NF + f) * 3 + q on 1-D planes,
    ((m * NF + f) * 3 + qx) * 3 + qy on 2-D ones."""
    e = m * nfields + f
    for d in off:
        e = e * 3 + d + 1
    return e


def _at(tr, off, plane):
    """The C expressions of a plane position at offset ``off`` (the wrap of
    the plane), or of the first position where ``plane`` is False."""
    if tr.rank == 1:
        return "x" if not plane or off[0] == 0 else f"rows1d::pmod(x + {off[0]}, A.N)"
    names = []
    for axis, d, n in zip("xy", off, ("A.X", "A.Y")):
        names.append("0" if not plane else axis if d == 0 else f"rows2d::pmod({axis} + {d}, {n})")
    return names


def _generate(tr):
    """(the TracedRow struct, DUSED, forward ops, backward ops) of a trace;
    the struct's BLOCKS_PER_SM is left as ``@BLOCKS_PER_SM@``."""
    nodes = _reachable(tr._graph, tr._outputs)
    classes = _shift_classes(nodes)
    ops_f = sum(_node_ops(n) for n in {classes[n.index]: n for n in nodes}.values())
    names = {}
    fwd = []
    two = tr.rank == 2

    def e(n):
        return names[n.index]

    for n in nodes:
        op, a = n.op, n.args
        if op == "lit":
            names[n.index] = _float_literal(a[0]) if n.dtype == _F else ("true" if a[0] else "false") if n.dtype == _B \
                else str(a[0])
            continue
        if op == "detach":
            names[n.index] = e(a[0])
            continue
        if op == "field":
            f, m, off = a
            names[n.index] = "v" + _sample(m, f, off)
            continue
        name = f"t{n.index}"
        names[n.index] = name
        if op == "data":
            d, off = a
            if two:
                expr = f"rows2d::data_at(A, {d}, it, {', '.join(_at(tr, off, tr.data[d]))})"
            else:
                expr = f"rows1d::data_at(A, {d}, it, {_at(tr, off, tr.data[d])})"
        elif op == "const":
            c, off = a
            if not tr.consts[c][0]:
                expr = f"__ldg(A.consts[{c}])"
            elif two:
                cx, cy = _at(tr, off, True)
                expr = f"__ldg(A.consts[{c}] + (size_t){cx} * A.Y + {cy})"
            else:
                expr = f"__ldg(A.consts[{c}] + {_at(tr, off, True)})"
        elif op == "param":
            expr = f"P[{a[0]}]"
        elif op == "it":
            expr = "it"
        elif op == "T":  # the global row count on a masked launch
            expr = "rows2d::model_T(A)" if two else "rows1d_traced::model_T(A)"
        elif op in _BINARY:
            expr = f"{e(a[0])} {_BINARY[op]} {e(a[1])}"
        elif op in _UNARY:
            expr = f"{_UNARY[op]}({e(a[0])})" if n.dtype == _F else f"abs({e(a[0])})"
        elif op == "neg":
            expr = f"-{e(a[0])}"
        elif op == "not":
            expr = f"!{e(a[0])}"
        elif op == "recip":
            expr = f"1.0f / {e(a[0])}"
        elif op == "sigmoid":
            expr = f"1.0f / (1.0f + expf(-{e(a[0])}))"
        elif op in ("min", "max"):
            expr = f"rows1d_traced::{op}_of({e(a[0])}, {e(a[1])})"
        elif op == "pow":
            expr = _pow_expr(e(a[0]), _f32_of(a[1]))[0]
        elif op == "where":
            expr = f"{e(a[0])} ? {e(a[1])} : {e(a[2])}"
        elif op == "tof":
            expr = f"(float){e(a[0])}"
        elif op == "toi":
            expr = f"(int){e(a[0])}"
        else:
            raise AssertionError(op)
        fwd.append(f"const {_CTYPE[n.dtype]} {name} = {expr};")
    fwd += [f"res[{k}] = {e(r)};" for k, r in enumerate(tr._outputs)]

    adj, dused, pacc, ops_a = _adjoint(tr, nodes, e, classes)
    dmask = 0
    for (m, f, off) in dused:
        dmask |= 1 << _entry(tr.nfields, m, f, off)
    param_sizes = " && ".join(f"A.param_size[{p}] == {_numel(s)}" for p, s in enumerate(tr.param_shapes))
    takes = f"A.nterms == MAXT && A.nparams == {tr.nparams}" + (f" && {param_sizes}" if param_sizes else "")
    ind = "      "
    grads = f"""    if constexpr (GRADS) {{
{ind}{(chr(10) + ind).join(adj) if adj else "(void)D;"}
      if (own) {{
{ind}  {(chr(10) + ind + "  ").join(pacc) if pacc else "(void)0;"}
      }}
    }}"""
    if two:
        lo, hi = dmask & (2**64 - 1), dmask >> 64
        body = f"""// The row model traced from {tr.name}.
struct TracedRow {{
  static constexpr int NF = {tr.nfields}, HIST = {tr.hist}, MAXT = {tr.nterms}, NP = {tr.nparams};
  // The D entries ((m * NF + f) * 3 + qx) * 3 + qy that eval writes, bits of DUSED_HI:DUSED_LO.
  static constexpr unsigned long long DUSED_LO = {lo:#x}ull, DUSED_HI = {hi:#x}ull;
  static constexpr int BLOCKS_PER_SM = @BLOCKS_PER_SM@;

  __host__ __device__ static constexpr bool used(int e) {{
    return e < 64 ? ((DUSED_LO >> e) & 1ull) != 0 : ((DUSED_HI >> (e < 64 ? 0 : e - 64)) & 1ull) != 0;
  }}

  static bool takes(const rows2d::Rows2DArgs& A) {{ return {takes}; }}

  template <bool GRADS, class Args>
  __host__ __device__ __forceinline__ static void eval(const Args& A, const float* P, int it, int x, int y,
                                                       const float (&v)[HIST + 1][NF][3][3], const float* g2,
                                                       float* res, float (&D)[HIST + 1][NF][3][3], float* pacc,
                                                       bool own) {{
    (void)P;
    (void)x;
    (void)y;
    (void)g2;
    (void)pacc;
    (void)own;
{ind}{(chr(10) + ind).join(fwd)}
{grads}
  }}
}};
"""
    else:
        body = f"""// The row model traced from {tr.name}.
struct TracedRow {{
  static constexpr int NF = {tr.nfields}, HIST = {tr.hist}, MAXT = {tr.nterms}, NP = {tr.nparams};
  static constexpr unsigned DUSED = {dmask:#x}u;
  static constexpr int BLOCKS_PER_SM = @BLOCKS_PER_SM@;
  static constexpr bool FACES = false, REG_PARAMS = true, CELL_PARAMS = true;
  struct Face {{}};

  static bool takes(const rows1d::Rows1DArgs& A) {{ return {takes}; }}

  template <bool GRADS, class Args>
  __host__ __device__ __forceinline__ static void eval(const Args& A, const float* P, int it, int x,
                                                       const float (&v)[HIST + 1][NF][3], const Face&, const Face&,
                                                       const float* g2, float* res, float (&D)[HIST + 1][NF][3],
                                                       float (&)[2], float* pacc, bool own) {{
    (void)P;
    (void)x;
    (void)g2;
    (void)pacc;
    (void)own;
{ind}{(chr(10) + ind).join(fwd)}
{grads}
  }}
}};
"""
    return body, dmask, ops_f, ops_f + ops_a


def _adjoint(tr, nodes, e, classes):
    """(statements, the D entries written as (m, f, q), the pacc
    statements, fp32 operations) of the reverse mode over ``nodes``,
    seeded with g2[k] * res[k].  The operations count each shift class
    (``_shift_classes``) once: a contribution once per (class of the
    node that sends it, operand), the sum of a class's cotangent once over
    the contributions its members take."""
    cts, active = {}, set()
    for n in nodes:  # the values a field sample or a param reaches, not through detach
        if n.op in ("field", "param") or n.op != "detach" and any(
                isinstance(a, _Node) and a.index in active for a in n.args):
            active.add(n.index)
    sent, taken = {}, {}  # {(sender's class, operand): ops}, {class: its contributions}
    edge = [None, 0]

    def add(n, expr, ops=0):
        key = (edge[0], edge[1])
        edge[1] += 1
        if n.dtype == _F and n.index in active:
            cts.setdefault(n.index, []).append(expr)
            sent[key] = ops
            taken.setdefault(classes[n.index], set()).add(key)

    for k, r in enumerate(tr._outputs):
        edge[:] = [("seed", k), 0]
        add(r, f"g2[{k}] * {e(r)}", 1)
    out, dused, pacc, ops = [], [], [], 0
    for n in reversed(nodes):
        terms = cts.get(n.index)
        if not terms:
            continue
        edge[:] = [classes[n.index], 0]
        gname = f"ct{n.index}"
        out.append(f"const float {gname} = {' + '.join(terms)};")
        op, a, y = n.op, n.args, e(n)
        if op == "field":
            f, m, off = a
            dused.append((m, f, off))
            out.append(f"D{_sample(m, f, off)} = {gname};")
        elif op == "param":
            pacc.append(f"pacc[{a[0]}] += {gname};")
            ops += 1
        elif op == "add":
            add(a[0], gname)
            add(a[1], gname)
        elif op == "sub":
            add(a[0], gname)
            add(a[1], f"-{gname}", 1)
        elif op == "mul":
            add(a[0], f"{gname} * {e(a[1])}", 1)
            add(a[1], f"{gname} * {e(a[0])}", 1)
        elif op == "div":  # torch: grad / other, -grad * ((self / other) / other)
            add(a[0], f"{gname} / {e(a[1])}", 1)
            add(a[1], f"-{gname} * ({y} / {e(a[1])})", 3)
        elif op == "neg":
            add(a[0], f"-{gname}", 1)
        elif op == "recip":  # torch: -grad * (result * result)
            add(a[0], f"-{gname} * ({y} * {y})", 3)
        elif op == "pow":
            ex = _f32_of(a[1])
            if ex != 0.0:
                p, k = _pow_expr(e(a[0]), ex - 1.0)
                add(a[0], f"{gname} * ({_float_literal(a[1])} * {p})", 2 + k)
        elif op == "tanh":  # tanh_backward: grad * (1 - y * y)
            add(a[0], f"{gname} * (1.0f - {y} * {y})", 3)
        elif op == "exp":
            add(a[0], f"{gname} * {y}", 1)
        elif op == "log":
            add(a[0], f"{gname} / {e(a[0])}", 1)
        elif op == "sqrt":  # grad / (2 * result)
            add(a[0], f"{gname} / (2.0f * {y})", 2)
        elif op == "rsqrt":  # -0.5 * grad * result^3
            add(a[0], f"-0.5f * {gname} * ({y} * {y} * {y})", 4)
        elif op == "sigmoid":  # sigmoid_backward: grad * (1 - y) * y
            add(a[0], f"{gname} * (1.0f - {y}) * {y}", 3)
        elif op == "abs":  # grad * sgn(x): 0 at 0
            x = e(a[0])
            add(a[0], f"({x} > 0.0f ? {gname} : {x} < 0.0f ? -{gname} : 0.0f)", 1)
        elif op in ("min", "max"):  # ties split the gradient; else the chosen operand takes it
            x0, x1 = e(a[0]), e(a[1])
            cmp = "<" if op == "min" else ">"
            add(a[0], f"({x0} == {x1} ? 0.5f * {gname} : {x0} {cmp} {x1} ? {gname} : 0.0f)", 1)
            add(a[1], f"({x0} == {x1} ? 0.5f * {gname} : {x1} {cmp} {x0} ? {gname} : 0.0f)", 1)
        elif op == "where":
            add(a[1], f"({e(a[0])} ? {gname} : 0.0f)")
            add(a[2], f"({e(a[0])} ? 0.0f : {gname})")
        # data, consts, it, T, comparisons and casts carry no gradient
    ops += sum(sent.values()) + sum(len(keys) - 1 for keys in taken.values())
    return out, sorted(dused), pacc, ops


def _unit(tr):
    """The .cu unit of a trace: the row model and the rows1d or rows2d entry
    points of model id 0, the masked per-shard pair among them."""
    if tr.rank == 2:
        return _unit2d(tr)
    return f"""// A row model of the 1-D tile kernels (rows1d.cuh), generated by
// odil_torch/ops/rowtrace.py from the row function {tr.name}
// ({tr.nfields} fields, hist {tr.hist}, {tr.nterms} terms, {tr.nparams} params).
// Replaces, for this row function, the TPU kernels that trace it into their
// bodies: _forward_blocked/_backward_blocked (odil_tpu/ops/rowwise.py:322,
// :396), on the row function that odil_tpu/halo.py:873-885 wraps for a
// shard too (the masked pair, odil_rows1d_halo_*), and
// _forward_stream/_backward_stream (:616, :690).

#include <cuda_runtime.h>

#include "rows1d.cuh"
#include "rows1d_traced.cuh"

namespace {{

{tr.body}
}}  // namespace

extern "C" {{

int odil_rows1d_args_size() {{ return (int)sizeof(rows1d::Rows1DArgs); }}

int odil_rows1d_halo_args_size() {{ return (int)sizeof(rows1d::Rows1DHaloArgs); }}

int odil_rows1d_tile(int what) {{
  return what == 0 ? rows1d::TILE : what == 1 ? rows1d::max_slab<TracedRow>() : rows1d::NTHREADS;
}}

// The blocks an SM holds for modes 1-3 and the masked 5-7.
int odil_rows1d_resident_blocks(int model, int mode) {{
  return model == 0 ? rows1d::resident<TracedRow>(mode) : 0;
}}

const char* odil_cuda_error_string(int err) {{ return cudaGetErrorString((cudaError_t)err); }}

int odil_rows1d_forward(int model, const rows1d::Rows1DArgs* a, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::forward<TracedRow, false>(*a, (cudaStream_t)stream);
}}

int odil_rows1d_backward(int model, const rows1d::Rows1DArgs* a, int with_sums, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::backward<TracedRow, false>(*a, with_sums, (cudaStream_t)stream);
}}

// The masked per-shard pair: the model sees the global row and row count
// (rows1d_traced::model_T, the flags of the launch).
int odil_rows1d_halo_forward(int model, const rows1d::Rows1DHaloArgs* a, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::forward<TracedRow, true>(*a, (cudaStream_t)stream);
}}

int odil_rows1d_halo_backward(int model, const rows1d::Rows1DHaloArgs* a, int with_sums, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows1d::backward<TracedRow, true>(*a, with_sums, (cudaStream_t)stream);
}}

}}  // extern "C"
"""


def _unit2d(tr):
    return f"""// A row model of the 2-D tile kernels (rows2d.cuh), generated by
// odil_torch/ops/rowtrace.py from the row function {tr.name}
// ({tr.nfields} fields, hist {tr.hist}, {tr.nterms} terms, {tr.nparams} params).
// Replaces, for this row function, the TPU kernels that trace it into their
// bodies on (T, X, Y) planes: _forward/_backward (odil_tpu/ops/rowwise.py:132,
// :185), _forward_blocked/_backward_blocked (:322, :396),
// _forward_stream/_backward_stream (:616, :690) and the x-tiled pair
// _forward_tiled/_backward_tiled (odil_tpu/ops/rowwise_tiled.py:187, :283),
// with xpad on a shard's block the masked pair (odil_rows2d_halo_*).

#include <cuda_runtime.h>

#include "rows1d_traced.cuh"
#include "rows2d.cuh"

namespace {{

{tr.body}
}}  // namespace

extern "C" {{

int odil_rows2d_args_size() {{ return (int)sizeof(rows2d::Rows2DArgs); }}

int odil_rows2d_halo_args_size() {{ return (int)sizeof(rows2d::Rows2DHaloArgs); }}

// The tile's rows (0), columns (1) and threads (2), and the dynamic shared
// memory of a forward (3) and a backward (4) block.
int odil_rows2d_tile(int what) {{ return rows2d::tile_info<TracedRow>(what); }}

// The blocks the card holds at once (mode: 1 the sums, 2 the gradients, 3
// both, plus 4 masked).
int odil_rows2d_resident_blocks(int model, int mode) {{
  return model == 0 ? rows2d::resident<TracedRow>(mode) : 0;
}}

const char* odil_cuda_error_string(int err) {{ return cudaGetErrorString((cudaError_t)err); }}

int odil_rows2d_forward(int model, const rows2d::Rows2DArgs* a, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows2d::forward<TracedRow, false>(*a, (cudaStream_t)stream);
}}

int odil_rows2d_backward(int model, const rows2d::Rows2DArgs* a, int with_sums, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows2d::backward<TracedRow, false>(*a, with_sums, (cudaStream_t)stream);
}}

int odil_rows2d_halo_forward(int model, const rows2d::Rows2DHaloArgs* a, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows2d::forward<TracedRow, true>(*a, (cudaStream_t)stream);
}}

int odil_rows2d_halo_backward(int model, const rows2d::Rows2DHaloArgs* a, int with_sums, void* stream) {{
  if (model != 0) return (int)cudaErrorInvalidValue;
  return rows2d::backward<TracedRow, true>(*a, with_sums, (cudaStream_t)stream);
}}

}}  // extern "C"
"""


def _unit_mg(tr):
    return f"""// A row model of the multigrid-fused walk (mg_rows2d.cuh), generated by
// odil_torch/ops/rowtrace.py from the row function {tr.name}
// ({tr.nfields} fields, hist {tr.hist}, {tr.nterms} terms, {tr.nparams} params).
// Replaces, for this row function, the TPU kernels that trace it into their
// bodies on the multigrid route: _forward_mg (odil_tpu/ops/rowwise_mg.py:257),
// _backward_mg (:350) with and without the sums, with lvl2 (the two-level
// fusion) and with wraps_in/emit_dwraps (a shard's local block), and their
// tiled forms past the TPU's VMEM (rowwise_mg_tiled._loss_and_grads_tiled
// :145, rowwise_mg_local_tiled._loss_and_grads_local_tiled :259).

#include <cuda_runtime.h>

#include "mg_rows2d.cuh"
#include "rows1d_traced.cuh"

namespace {{

{tr.body}
}}  // namespace

extern "C" {{

// The argument structs' sizes (form: 0 the whole plane, 1 depth 2, 2 the
// local block).
int odil_mg2d_args_size(int form) {{
  return form == 0 ? (int)sizeof(mg2d::Mg2DArgs)
                   : form == 1 ? (int)sizeof(mg2d::Mg2DLvl2Args) : (int)sizeof(mg2d::Mg2DLocalArgs);
}}

// The walk's tile: its rows (axis 0), columns (1) and threads (2).
int odil_mg2d_tile(int axis) {{ return axis == 0 ? mg2d::TILE_X : axis == 1 ? mg2d::TILE_Y : mg2d::NTHREADS; }}

// The blocks the card holds at once and the dynamic shared memory of a
// block of a form's launch (mode: 1 the sums, 2 the gradients, 3 both).
int odil_mg2d_resident_blocks(int form, int mode) {{ return mg2d::resident<TracedRow>(form, mode); }}

int odil_mg2d_smem(int form, int mode) {{ return mg2d::smem<TracedRow>(form, mode); }}

// The floats of the dP windows of a launch over T rows, X (+ the local tile
// shift) and Y columns in slabs of `slab` rows.
long long odil_mg2d_dp_floats(int T, int X, int Y, int slab) {{
  return mg2d::dp_floats<TracedRow::NF>(T, X, Y, slab);
}}

const char* odil_cuda_error_string(int err) {{ return cudaGetErrorString((cudaError_t)err); }}

// Loss-only pass (_forward_mg): the per-term sums into A->sums.
int odil_mg2d_forward(const mg2d::Mg2DArgs* a, void* stream) {{
  return mg2d::launch<TracedRow, mg2d::MODE_SUMS>(*a, (cudaStream_t)stream);
}}

// Gradient pass (_backward_mg): dt0, dP and the param cotangents, plus the
// sums when with_sums.
int odil_mg2d_backward(const mg2d::Mg2DArgs* a, int with_sums, void* stream) {{
  return mg2d::backward<TracedRow>(*a, with_sums, (cudaStream_t)stream);
}}

// Two-level gradient pass (_backward_mg with lvl2): dt0, dP1, dP2 and the
// param cotangents, plus the sums when with_sums.
int odil_mg2d_backward2(const mg2d::Mg2DLvl2Args* a, int with_sums, void* stream) {{
  return mg2d::backward<TracedRow>(*a, with_sums, (cudaStream_t)stream);
}}

// The local-block gradient pass with the sums (_backward_mg with wraps_in /
// emit_dwraps): dt0, dP over the window, dheads and the param cotangents.
int odil_mg2d_backward_local(const mg2d::Mg2DLocalArgs* a, int with_sums, void* stream) {{
  if (!with_sums) return (int)cudaErrorInvalidValue;
  return mg2d::launch<TracedRow, mg2d::MODE_SUMS | mg2d::MODE_GRADS>(*a, (cudaStream_t)stream);
}}

}}  // extern "C"
"""
