"""Context: the user operator's window onto the state.

PyTorch counterpart of ``odil_tpu/context.py``: ``ctx.field(key, *shift,
loc=..., frozen=...)`` flattens a MultigridField to its fine grid, converts
the staggered location by pad/trim, applies the periodic shift with
``roll`` and caches the sample; ``frozen=True`` detaches it from autograd.
The ``rowwise_terms`` service belongs to the generic row-wise kernels, which
are a later slice of the port.
"""

from .fields import Array, Field, MultigridField

__all__ = ["Context"]


class Context:

    class Raw:
        """Wraps a precomputed mean loss term (used verbatim, not squared)."""

        def __init__(self, value):
            self.value = value

    def __init__(self, domain, state, extra=None, tracers=None):
        self.domain = domain
        self.state = state
        self.extra = extra
        self.tracers = tracers
        self.dtype = domain.dtype
        self.mod = domain.mod
        # Filled by Problem when mg_partial=True: key -> (term0, factor0, P).
        self.mg_partials = {}
        self.desc_to_array = dict()
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
            return field.array.detach() if frozen else field.array
        if not isinstance(field, (Field, MultigridField)):
            raise TypeError(f"Expected Field or MultigridField, got {type(field).__name__} for '{key}'")
        shift = tuple(shift) or (0,) * domain.ndim
        if len(shift) != domain.ndim:
            raise RuntimeError(f"Expected {domain.ndim} shift components, got shift={shift}")
        loc = loc or field.loc
        desc = (key, shift, loc)
        array = self.desc_to_array.get(desc)
        if array is None:
            array = self._resolve_sample(field, shift, loc)
            self.desc_to_array[desc] = array
        return array.detach() if frozen else array
