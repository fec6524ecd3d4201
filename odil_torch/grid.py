"""Structured-grid Domain: geometry, staggered locations, multigrid hierarchy,
state initialization and the flat array order.

PyTorch counterpart of ``odil_tpu/grid.py:52-473``.  Every tensor the
domain creates lives on ``device`` (default ``cuda``; the CPU tests pass
``device="cpu"``).  ``mesh`` (``parallel.Mesh``) and ``partition`` (grid
dimension name -> mesh axis name) describe the shards of the halo path
(``halo.py``, ``Problem.make_loss_fn(state, halo=True)``); the arrays stay
whole on ``device``.
"""

import math

import numpy as np
import torch

from . import runtime
from .backend import ModTorch
from .fields import Array, Field, MultigridField, NeuralNet, State, field_arrays, set_field_arrays
from .nn import eval_neural_net, make_neural_net
from .transfer import interp_to_finer

__all__ = ["Domain", "latin_hypercube"]


def latin_hypercube(ndim, size, dtype):
    """Latin-hypercube sample of `size` points from the unit cube, drawn
    from numpy's global RNG exactly as ``odil_tpu/grid.py:41`` draws them
    (``setup_outdir`` seeds it), as a numpy array of shape (size, ndim)."""
    edges = np.linspace(0, 1, size + 1, dtype=dtype)
    jitter = np.random.rand(size, ndim).astype(dtype)
    pts = edges[:size, None] + jitter * (edges[1:, None] - edges[:size, None])
    out = np.empty_like(pts)
    for j in range(ndim):
        out[:, j] = pts[np.random.permutation(size), j]
    return out


class Domain:
    """Descriptor of a structured grid with named axes and staggered values.

    cshape: grid size per axis, measured in cells.
    dimnames: axis names (default x, y, z, ...).
    lower/upper: physical bounds (scalar or per-axis).
    multigrid: build the coarsening hierarchy for multigrid decomposition.
    mg_*: hierarchy options (levels, per-level factors, active axes, interp).
    device: where the domain's tensors live (default ``cuda``).
    mesh, partition: optional ``parallel.Mesh`` and dict mapping dimension
        names to mesh axis names, for the halo path; each partitioned cell
        count must divide its mesh axis (``odil_tpu/halo.py:31-33``).
    """

    def __init__(
        self,
        cshape,
        dimnames=None,
        lower=0.0,
        upper=1.0,
        dtype=None,
        multigrid=False,
        mg_convert_all=True,
        mg_nlvl=None,
        mg_factors=None,
        mg_axes=None,
        mg_interp=None,
        device="cuda",
        mesh=None,
        partition=None,
    ):
        runtime.pin_fp32()
        cshape = tuple(int(n) for n in cshape)
        ndim = len(cshape)
        self.ndim = ndim
        self.cshape = cshape
        self.dimnames = list(dimnames) if dimnames else ["x", "y", "z", "w", "v", "u"][:ndim]
        assert len(self.dimnames) == ndim, f"dimnames={self.dimnames} vs cshape={cshape}"
        self.mesh = mesh
        self.partition = dict(partition) if partition else None
        if mesh is not None and not partition:
            raise NotImplementedError(
                "odil_torch.Domain: a mesh without a partition replicates every array (the JAX package's GSPMD "
                "route), which is not ported; give partition= and evaluate with halo=True"
            )
        if partition and mesh is None:
            raise ValueError("Domain: partition needs a mesh")
        if mesh is not None:
            sizes = mesh.shape
            for name, axis in self.partition.items():
                if name not in self.dimnames or axis not in sizes:
                    raise ValueError(f"Domain: partition {name!r} -> {axis!r} names no grid dimension or mesh axis")
                n = cshape[self.dimnames.index(name)]
                if n % sizes[axis]:
                    raise ValueError(
                        f"Domain: {n} cells along '{name}' do not divide mesh axis '{axis}' ({sizes[axis]} shards)"
                    )
        self.device = torch.device(device)
        self.mod = ModTorch(self.device)
        self.dtype = np.dtype(dtype) if dtype is not None else runtime.default_dtype()
        self.lower = (np.ones(ndim) * lower).astype(self.dtype)
        self.upper = (np.ones(ndim) * upper).astype(self.dtype)

        self.multigrid = multigrid
        if multigrid:
            self.mg_factors = mg_factors
            mg_axes = mg_axes or [True] * ndim
            nlvl_max = min(
                round(math.log2(n)) if active else max(cshape) for n, active in zip(cshape, mg_axes)
            )
            mg_nlvl = min(mg_nlvl, nlvl_max) if mg_nlvl is not None else nlvl_max
            assert mg_nlvl >= 1
            self.mg_nlvl = mg_nlvl
            self.mg_cshapes = [
                tuple(n >> lvl if active else n for n, active in zip(cshape, mg_axes))
                for lvl in range(mg_nlvl)
            ]
            for lvl in range(1, mg_nlvl):
                for d in range(ndim):
                    if mg_axes[d] and self.mg_cshapes[lvl - 1][d] != 2 * self.mg_cshapes[lvl][d]:
                        raise ValueError(f"Expected exact halving per level, got cshapes={self.mg_cshapes}")
            self.mg_axes = mg_axes
            self.mg_interp = mg_interp
            self.mg_convert_all = mg_convert_all

    # -- Geometry ----------------------------------------------------------

    def _dim_indices(self, dims, dimnames):
        res = dims if dims is not None and len(dims) else range(len(dimnames))
        return tuple(dimnames.index(d) if isinstance(d, str) else d for d in res)

    def cast(self, value, dtype=None):
        return self.mod.cast(value, dtype or self.dtype)

    def get_minimal(self):
        """The geometry alone (``core_min.Domain``: numpy, no device)."""
        from . import core_min

        return core_min.Domain(self)

    def _points_1d(self, d, loc):
        if loc == "c":
            x = np.linspace(self.lower[d], self.upper[d], self.cshape[d], endpoint=False, dtype=self.dtype)
            if len(x) > 1:
                x = x + (x[1] - x[0]) * 0.5
            return x
        if loc == "n":
            return np.linspace(self.lower[d], self.upper[d], self.cshape[d] + 1, dtype=self.dtype)
        raise ValueError("Unknown loc=" + loc)

    def points_1d(self, *dims, loc=None):
        loc = loc or "c" * self.ndim
        idims = self._dim_indices(dims, self.dimnames)
        res = [torch.as_tensor(self._points_1d(i, c), device=self.device) for i, c in zip(idims, loc)]
        return res[0] if len(dims) == 1 else res

    def points(self, *dims, loc=None):
        """Meshgrid coordinate tensors for the requested dims at `loc`.
        Axes marked '.' in loc are absent from the outputs."""
        loc = loc or "c" * self.ndim
        assert len(loc) == self.ndim, f"loc={loc} vs ndim={self.ndim}"
        active_names = [v for v, c in zip(self.dimnames, loc) if c != "."]
        idims = self._dim_indices(dims, active_names)
        axes_1d = [self._points_1d(d, loc[d]) for d in range(self.ndim) if loc[d] != "."]
        grids = self.mod.meshgrid(*axes_1d, indexing="ij")
        res = tuple(grids[i] for i in idims)
        return res[0] if len(dims) == 1 else res

    def indices(self, *dims, loc=None):
        loc = loc or "c" * self.ndim
        active_names = [v for v, c in zip(self.dimnames, loc) if c in "cn"]
        idims = self._dim_indices(dims, active_names)
        axes_1d = [
            np.arange(self.cshape[d] + (1 if loc[d] == "n" else 0)) for d in range(self.ndim) if loc[d] in "cn"
        ]
        grids = self.mod.meshgrid(*axes_1d, indexing="ij")
        res = tuple(grids[i] for i in idims)
        return res[0] if len(dims) == 1 else res

    @staticmethod
    def _get_field_shape(cshape, loc=None):
        loc = loc or "c" * len(cshape)
        assert all(c in "cn" for c in loc)
        return tuple(s + 1 if c == "n" else s for s, c in zip(cshape, loc))

    def get_field_shape(self, loc=None):
        return self._get_field_shape(self.cshape, loc=loc)

    def size(self, *dims, loc=None):
        loc = loc or "c" * self.ndim
        assert len(loc) == self.ndim, f"loc={loc} vs ndim={self.ndim}"
        idims = self._dim_indices(dims, self.dimnames)
        res = [self.cshape[i] + (1 if loc[i] == "n" else 0) for i in idims]
        return res[0] if len(dims) == 1 else res

    def step_by_dim(self, i):
        return (self.upper[i] - self.lower[i]) / self.cshape[i]

    def step(self, *dims):
        idims = self._dim_indices(dims, self.dimnames)
        res = tuple(self.step_by_dim(i) for i in idims)
        return res[0] if len(dims) == 1 else res

    # -- Random sampling (PINN collocation) --------------------------------

    def random_inner(self, size):
        """`size` points inside the domain, one numpy array per axis."""
        pts = latin_hypercube(self.ndim, size, dtype=self.dtype).T
        for i in range(self.ndim):
            pts[i] = self.lower[i] + (self.upper[i] - self.lower[i]) * pts[i]
        return [p for p in pts]

    def random_boundary(self, normal, side, size):
        """`size` points on the face with the given normal axis and side (0
        lower, 1 upper), one numpy array per axis."""
        assert normal < self.ndim
        assert side in (0, 1)
        pts = latin_hypercube(self.ndim - 1, size, dtype=self.dtype).T
        face = np.ones(size, dtype=self.dtype) * side
        pts = np.vstack((pts[:normal], face, pts[normal:]))
        for i in range(self.ndim):
            pts[i] = self.lower[i] + (self.upper[i] - self.lower[i]) * pts[i]
        return [p for p in pts]

    # -- Multigrid decomposition -------------------------------------------

    def multigrid_to_regular(self, mgfield):
        """u = terms[0]*f0 + I(terms[1]*f1 + I(terms[2]*f2 + ...))."""
        factors = mgfield.factors or self.mg_factors or [1] * len(mgfield.terms)
        axes = mgfield.axes or self.mg_axes
        assert len(factors) == len(mgfield.terms)
        method = mgfield.method or self.mg_interp
        loc_active = "".join(l if ax else "." for l, ax in zip(mgfield.loc, axes))
        scaled = [t.array * f for t, f in zip(mgfield.terms, factors)]
        acc = scaled[-1]
        for arr in reversed(scaled[:-1]):
            acc = arr + interp_to_finer(acc, loc_active, method)
        return Field(acc, loc=mgfield.loc)

    def get_regular_array(self, field):
        if isinstance(field, (Field, Array)):
            return field.array
        if isinstance(field, MultigridField):
            return self.multigrid_to_regular(field).array
        raise TypeError(f"Expected Field or MultigridField, got {type(field).__name__}")

    def regular_to_multigrid(self, field, cshapes=None, factors=None, method=None):
        """Seeds a MultigridField: level 0 holds the field, coarser levels zero."""
        if isinstance(field, MultigridField):
            raise TypeError(f"Expected Field or tensor, got {type(field).__name__}")
        field = self.init_field(field)
        cshapes = cshapes or self.mg_cshapes
        factors = factors or self.mg_factors or [1] * len(cshapes)
        assert len(cshapes) == len(factors)
        method = method or self.mg_interp
        terms = [Field(field.array / factors[0], loc=field.loc, cshape=field.cshape)]
        for cs in cshapes[1:]:
            zero = self.mod.zeros(self._get_field_shape(cs, loc=field.loc), dtype=self.dtype)
            terms.append(Field(zero, loc=field.loc, cshape=cs))
        return MultigridField(terms=terms, loc=field.loc, factors=factors, method=method)

    # -- State construction ------------------------------------------------

    def init_field(self, field):
        """Normalizes any accepted field spec into an initialized field object."""
        if field is None:
            return self.init_field(Field(None, loc="c" * self.ndim, cshape=self.cshape))
        if isinstance(field, np.ndarray) or torch.is_tensor(field):
            return self.init_field(Field(field, loc="c" * field.ndim, cshape=field.shape))
        if isinstance(field, Field):
            cshape = tuple(field.cshape) if field.cshape else self.cshape
            loc = field.loc or "c" * len(cshape)
            assert len(loc) == len(cshape)
            shape = self._get_field_shape(cshape, loc=loc)
            array = field.array
            if array is None:
                array = self.mod.zeros(shape, dtype=self.dtype)
            array = self.cast(array)
            assert tuple(array.shape) == shape, f"{tuple(array.shape)} vs {shape}"
            return Field(array, loc=loc, cshape=cshape)
        if isinstance(field, MultigridField):
            return MultigridField(
                [self.init_field(t) for t in field.terms],
                loc=field.loc,
                factors=field.factors,
                axes=field.axes,
                method=field.method,
            )
        if isinstance(field, NeuralNet):
            return NeuralNet([self.cast(w) for w in field.weights], [self.cast(b) for b in field.biases])
        if isinstance(field, list):
            return self.init_field(Array(self.cast(np.asarray(field)), shape=(len(field),)))
        if isinstance(field, Array):
            array = field.array
            if array is None:
                array = self.mod.zeros(field.shape, dtype=self.dtype)
            array = self.cast(array)
            return Array(array, tuple(array.shape))
        raise TypeError(f"Unknown field type '{type(field).__name__}'")

    def init_state(self, state):
        """Initializes every field of `state`, converting plain fields to
        multigrid decompositions when the domain hierarchy requests it."""
        fields = dict()
        for key, spec in state.fields.items():
            field = self.init_field(spec)
            if self.multigrid and self.mg_convert_all and not isinstance(field, (MultigridField, NeuralNet, Array)):
                field = self.regular_to_multigrid(spec)
            fields[key] = field
        return State(fields=fields, initialized=True)

    def arrays_from_field(self, field):
        return field_arrays(field)

    def arrays_from_state(self, state):
        """The state's tensors in the canonical flat order."""
        res = []
        for key in state.fields:
            res += field_arrays(state.fields[key])
        return res

    @staticmethod
    def arrays_to_field(arrays, field):
        return set_field_arrays(field, arrays)

    @staticmethod
    def arrays_to_state(arrays, state):
        """Puts `arrays` (the canonical flat order) into `state` in place;
        returns the number consumed."""
        offset = 0
        for key in state.fields:
            offset += set_field_arrays(state.fields[key], arrays[offset:])
        return offset

    def pack_field(self, field):
        return torch.cat([a.reshape(-1) for a in field_arrays(field)])

    def pack_state(self, state):
        """The state's tensors flattened into one vector."""
        return torch.cat([a.reshape(-1) for a in self.arrays_from_state(state)])

    def unpack_field(self, packed, field):
        arrays = field_arrays(field)
        sizes = [math.prod(a.shape) for a in arrays]
        parts = torch.split(packed[: sum(sizes)], sizes)
        set_field_arrays(field, [p.reshape(a.shape) for p, a in zip(parts, arrays)])
        return sum(sizes)

    def unpack_state(self, packed, state):
        """Fills `state` in place from a vector of ``pack_state``'s layout."""
        offset = 0
        for key in state.fields:
            offset += self.unpack_field(packed[offset:], state.fields[key])
        return offset

    # -- Neural nets -------------------------------------------------------

    def make_neural_net(self, layers, generator):
        """A NeuralNet on this domain's device and dtype, its weights drawn
        from `generator` (a CPU ``torch.Generator``)."""
        return make_neural_net(layers, self.dtype, self.device, generator)

    def neural_net(self, state, key):
        """The network `key` of `state` as a function of its inputs."""
        net = state.fields[key]
        if not isinstance(net, NeuralNet):
            raise TypeError(f"Expected NeuralNet, got {type(net).__name__} for '{key}'")
        return lambda *inputs: eval_neural_net(net, inputs)

    def field(self, state, key, *shift):
        """The data tensor of a field on the fine grid (a MultigridField
        flattened), periodically shifted by `shift` cells."""
        field = state.fields[key]
        if not isinstance(field, (Field, MultigridField, Array)):
            raise TypeError(f"Expected Field or MultigridField, got {type(field).__name__} for '{key}'")
        if isinstance(field, Array):
            if len(shift):
                raise RuntimeError("Array requires an empty shift")
            return field.array
        shift = shift or (0,) * self.ndim
        if len(shift) != self.ndim:
            raise RuntimeError(f"Expected {self.ndim} shift components, got shift={shift}")
        return self.mod.roll(self.get_regular_array(field), [-s for s in shift], range(self.ndim))

    def get_context(self, state, extra=None, tracers=None):
        from .context import Context

        return Context(self, state, extra=extra, tracers=tracers)
