"""State containers: Field, MultigridField, NeuralNet, Array, State.

PyTorch counterpart of ``odil_tpu/fields.py:21-80``.  JAX registers these as
pytrees; here the flat order is explicit: ``field_arrays`` lists a field's
tensors and ``state_from_arrays`` rebuilds a state from a flat list in the
same order, which is the order of ``Domain.arrays_from_state``.
"""

__all__ = ["Field", "MultigridField", "NeuralNet", "Array", "State", "field_arrays", "state_from_arrays"]


def _norm_shape(shape):
    return None if shape is None else tuple(int(s) for s in shape)


class Field:
    """A grid field: data tensor + staggered location + grid size in cells.

    loc: one character per axis, 'c' (cell center) or 'n' (node).
    """

    def __init__(self, array=None, loc=None, cshape=None):
        self.array = array
        self.loc = loc
        self.cshape = _norm_shape(cshape)

    def __repr__(self):
        return f"Field({self.array!r}, loc='{self.loc}', cshape={self.cshape})"


class MultigridField:
    """A field represented as a sum of interpolated per-level corrections:
    u = sum_i interp^i(terms[i].array * factors[i]), coarsest level last."""

    def __init__(self, terms=None, loc=None, factors=None, axes=None, method=None):
        self.terms = terms
        self.loc = loc
        self.factors = factors
        self.axes = axes
        self.method = method

    def __repr__(self):
        return f"MultigridField(nterms={len(self.terms or [])}, loc='{self.loc}')"


class NeuralNet:
    """A fully-connected tanh network: weights are (n_out, n_in) matrices,
    biases length n_out (``odil_tpu/fields.py:54-66``, default activation,
    no input or output maps)."""

    def __init__(self, weights, biases):
        self.weights = weights
        self.biases = biases

    def __repr__(self):
        return f"NeuralNet(layers={[tuple(w.shape) for w in self.weights]})"


class Array:
    """A non-grid vector of unknowns (e.g. inferred scalar coefficients)."""

    def __init__(self, array=None, shape=None):
        self.array = array
        self.shape = _norm_shape(shape)

    def __repr__(self):
        return f"Array({self.array!r}, shape={self.shape})"


class State:
    """Named collection of unknowns. ``fields`` maps name -> field object."""

    def __init__(self, fields=None, initialized=False):
        self.fields = fields if fields is not None else dict()
        self.initialized = initialized

    def __repr__(self):
        return f"State(fields={list(self.fields)}, initialized={self.initialized})"


def field_arrays(field):
    """Lists the data tensors of a field object in the canonical flat order
    (a NeuralNet's weights first, then its biases, as in
    ``odil_tpu/fields.py:173-174``)."""
    if isinstance(field, (Field, Array)):
        return [field.array]
    if isinstance(field, MultigridField):
        return [t.array for t in field.terms]
    if isinstance(field, NeuralNet):
        return list(field.weights) + list(field.biases)
    raise TypeError(f"Unknown field type '{type(field).__name__}'")


def _rebuild(field, arrays):
    """(new field holding the prefix of `arrays`, number consumed)."""
    if isinstance(field, Field):
        return Field(arrays[0], loc=field.loc, cshape=field.cshape), 1
    if isinstance(field, Array):
        return Array(arrays[0], shape=field.shape), 1
    if isinstance(field, MultigridField):
        n = len(field.terms)
        terms = [Field(a, loc=t.loc, cshape=t.cshape) for a, t in zip(arrays[:n], field.terms)]
        mg = MultigridField(terms, loc=field.loc, factors=field.factors, axes=field.axes, method=field.method)
        return mg, n
    if isinstance(field, NeuralNet):
        nw, n = len(field.weights), len(field.weights) + len(field.biases)
        return NeuralNet(list(arrays[:nw]), list(arrays[nw:n])), n
    raise TypeError(f"Unknown field type '{type(field).__name__}'")


def state_from_arrays(template, arrays):
    """A new State shaped like `template` holding `arrays` (flat order)."""
    fields = {}
    pos = 0
    for key, field in template.fields.items():
        fields[key], n = _rebuild(field, arrays[pos:])
        pos += n
    assert pos == len(arrays), (pos, len(arrays))
    return State(fields=fields, initialized=True)
