"""Context: the user operator's window onto the state.

PyTorch counterpart of ``odil_tpu/context.py``: ``ctx.field(key, *shift,
loc=..., frozen=...)`` flattens a MultigridField to its fine grid, converts
the staggered location by pad/trim, applies the periodic shift with
``roll`` and caches the sample; ``frozen=True`` detaches it from autograd.
``ctx.neural_net(key, frozen=...)`` evaluates a NeuralNet field pointwise.
``ctx.rowwise_terms`` runs a row function over named fields through the
row-wise kernels (``ops/rowwise.py``), eagerly or deferred for the one-pass
loss+grad route of ``Problem.make_loss_grad_fn``.

The two Newton modes of ``odil_tpu/context.py:37-77`` serve
``Problem.eval_operator_grad``:

- ``distinct_shift=True``: each (key, shift, loc) sample is resolved from a
  detached source, so every sample is an independent leaf;
- ``bindings``: a dict of descriptor -> tensor that replaces the samples
  (and an ``Array``'s array, a NeuralNet's weights and biases), so the
  operator can be differentiated with respect to them directly.

``key_to_array_jac`` records the ``Array`` and NeuralNet unknowns that need
a dense Jacobian block.
"""

from .fields import Array, Field, MultigridField, NeuralNet
from .nn import eval_neural_net
from .ops.rowwise import rowwise_loss_terms

__all__ = ["Context"]


class Context:

    class Raw:
        """Wraps a precomputed mean loss term (used verbatim, not squared)."""

        def __init__(self, value):
            self.value = value

    def __init__(self, domain, state, extra=None, tracers=None, distinct_shift=False, bindings=None):
        self.domain = domain
        self.state = state
        self.extra = extra
        self.tracers = tracers
        self.distinct_shift = distinct_shift
        self.bindings = bindings
        self.dtype = domain.dtype
        self.mod = domain.mod
        # Filled by Problem when mg_partial=True: key -> (term0, factor0, P).
        self.mg_partials = {}
        # Row-wise kernel calls: their declarations, and the deferred mode of
        # the one-pass route (calls recorded, placeholders returned).
        self.rowwise_calls = []
        self.rowwise_defer = False
        self.rowwise_deferred = []
        self.desc_to_array = dict()
        # Descriptors needing a dense Jacobian (Array and NeuralNet unknowns).
        self.key_to_array_jac = dict()
        self.step = domain.step
        self.size = domain.size
        self.indices = domain.indices
        self.points = domain.points

    def cast(self, value, dtype=None):
        return self.mod.cast(value, dtype or self.dtype)

    def _resolve_sample(self, field, shift, loc):
        mod = self.mod
        ndim = self.domain.ndim
        array = self.domain.get_regular_array(field)
        if self.distinct_shift:
            # Each shifted sample is an independent leaf: detach the source.
            array = array.detach()
        # Cell field read at node location: prepend one zero layer.
        pad_width = [(1, 0) if (lf == "c" and l == "n") else (0, 0) for lf, l in zip(field.loc, loc)]
        if any(w != (0, 0) for w in pad_width):
            array = mod.pad(array, pad_width=pad_width, mode="constant")
        if any(shift):
            array = mod.roll(array, [-s for s in shift], range(ndim))
        # Node field read at cell location: drop the trailing layer.
        trim = [slice(0, -1) if (lf == "n" and l == "c") else slice(None) for lf, l in zip(field.loc, loc)]
        if any(s != slice(None) for s in trim):
            array = array[tuple(trim)]
        return array

    def field(self, key, *shift, loc=None, frozen=False):
        domain = self.domain
        field = self.state.fields[key]
        if isinstance(field, Array):
            if len(shift):
                raise RuntimeError("Array requires an empty shift")
            desc = (key, None, None)
            bound = self.bindings is not None and desc in self.bindings
            array = self.bindings[desc] if bound else field.array
            self.key_to_array_jac[desc] = array
            return array.detach() if frozen else array
        if not isinstance(field, (Field, MultigridField)):
            raise TypeError(f"Expected Field or MultigridField, got {type(field).__name__} for '{key}'")
        shift = tuple(shift) or (0,) * domain.ndim
        if len(shift) != domain.ndim:
            raise RuntimeError(f"Expected {domain.ndim} shift components, got shift={shift}")
        loc = loc or field.loc
        desc = (key, shift, loc)
        if self.bindings is not None and desc in self.bindings:
            array = self.desc_to_array[desc] = self.bindings[desc]
            return array.detach() if frozen else array
        array = self.desc_to_array.get(desc)
        if array is None:
            array = self._resolve_sample(field, shift, loc)
            self.desc_to_array[desc] = array
        return array.detach() if frozen else array

    def rowwise_terms(
        self, row_fn, keys, params=(), data=(), consts=(), nterms=1, hist=1, halox=1, block_rows=None,
        stream=False,
    ):
        """Per-term mean-squared losses of ``row_fn`` over the named grid
        fields through the row-wise kernels, as a list of ``Context.Raw``
        terms: ``rowwise_loss_terms(row_fn, [ctx.field(k) for k in keys],
        ...)``.  ``hist`` and ``halox`` declare the row function's reach along
        t and x.  With ``rowwise_defer`` set (the one-pass route of
        ``Problem.make_loss_grad_fn``) the call is recorded in
        ``rowwise_deferred`` and the terms are placeholders carrying
        ``deferred = (call index, term index)``."""
        fields = tuple(self.field(k) for k in keys)
        self.rowwise_calls.append({"keys": tuple(keys), "hist": hist, "halox": halox, "nterms": nterms})
        if self.rowwise_defer:
            idx = len(self.rowwise_deferred)
            self.rowwise_deferred.append(
                dict(
                    row_fn=row_fn, keys=tuple(keys), fields=fields, params=tuple(params), data=tuple(data),
                    consts=tuple(consts), nterms=nterms, hist=hist, halox=halox, block_rows=block_rows,
                    stream=stream,
                )
            )
            out = []
            for t in range(nterms):
                r = Context.Raw(None)
                r.from_rowwise = True
                r.deferred = (idx, t)
                out.append(r)
            return out
        terms = rowwise_loss_terms(
            row_fn, fields, params=params, data=data, consts=consts, nterms=nterms, hist=hist, halox=halox,
            block_rows=block_rows, stream=stream,
        )
        out = []
        for t in terms:
            r = Context.Raw(t)
            r.from_rowwise = True
            out.append(r)
        return out

    def neural_net(self, key, frozen=False):
        """The NeuralNet field `key` as a function of its inputs; ``frozen``
        detaches its weights from autograd (``odil_tpu/context.py:234-255``).
        Under ``bindings`` the weights and biases are the bound list."""
        field = self.state.fields[key]
        if not isinstance(field, NeuralNet):
            raise TypeError(f"Expected NeuralNet, got {type(field).__name__} for '{key}'")
        desc = (key, None, None)
        net = field
        if self.bindings is not None and desc in self.bindings:
            params = list(self.bindings[desc])
            n = len(field.weights)
            net = NeuralNet(params[:n], params[n:])
        if self.distinct_shift or self.bindings is not None:
            self.key_to_array_jac[desc] = list(net.weights) + list(net.biases)
        return lambda *inputs: eval_neural_net(net, inputs, frozen=frozen)
