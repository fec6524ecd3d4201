"""Problem: turns a user operator into a loss and a loss-and-gradient function.

PyTorch counterpart of the parts of ``odil_tpu/problem.py`` on the flagship
path: ``loss_terms`` (:271), ``make_loss_fn`` (:293), the multigrid Horner
ladder (:49) with the level-1 partial (:129, ``partial_depth=1``), and both
routes of ``make_loss_grad_fn`` (:316-358): the fused multigrid route
(:360-425) and the generic one-pass route (:427-569).  Where neither
applies, ``make_loss_grad_fn`` returns None and the caller differentiates
``make_loss_fn`` with autograd, as ``bench.py:111`` does in JAX.
"""

from collections import defaultdict

import numpy as np
import torch

from .context import Context
from .fields import Field, MultigridField, State, _rebuild, field_arrays, state_from_arrays
from .ops.rowwise import onepass_supported, rowwise_loss_and_grads
from .transfer import interp_to_finer

__all__ = ["Problem"]


def _horner_ladder(terms, factors, loc, method, stop=0):
    """Folds the multigrid Horner ladder from the coarsest level down to level
    ``stop``: ``terms[stop]*factors[stop] + I(terms[stop+1]*factors[stop+1]
    + I(...))``.  ``stop=0`` is the full flatten."""
    acc = terms[-1] * factors[-1]
    for lvl in range(len(terms) - 2, stop - 1, -1):
        acc = terms[lvl] * factors[lvl] + interp_to_finer(acc, loc, method)
    return acc


class Problem:

    def __init__(self, operator, domain, extra=None, tracers=None, mg_partial=False):
        """
        operator: callable(ctx) returning a list of residual fields or
            (name, field) tuples; each field is an equation to drive to zero.
        domain: Domain instance.
        extra: Python payload available as ``ctx.extra``.
        tracers: dict of values visible as ``ctx.tracers``; 'epoch' defaults to 0.
        mg_partial: stop the multigrid Horner flatten one level early and
            expose ``ctx.mg_partials[key] = (term0, factor0, P)`` for the
            MG-fused kernel (ops/rowwise_mg.py).
        """
        self.domain = domain
        self.operator = operator
        self.extra = extra
        self.mg_partial = mg_partial
        tracers = dict(tracers) if tracers is not None else dict()
        tracers.setdefault("epoch", 0)
        self.tracers = tracers
        self._template = None
        self._names = None

    def _capture_structure(self, state):
        if self._template is None:
            self._template = state

    def state_from_arrays(self, arrays):
        """A State shaped like the captured one, holding `arrays`."""
        return state_from_arrays(self._template, list(arrays))

    def _run_operator(self, ctx):
        ff = self.operator(ctx)
        assert isinstance(ff, (tuple, list)) and len(ff), "Operator must return a non-empty list"
        names = [f[0] if isinstance(f, tuple) else "" for f in ff]
        nonempty = [n for n in names if n]
        assert len(nonempty) == len(set(nonempty)), f"Names of fields must be unique, got {nonempty}"
        self._names = names
        return names, [f[1] if isinstance(f, tuple) else f for f in ff]

    def _flatten_multigrid_batched(self, state, partial_out=None):
        """Flattens groups of identically-shaped MultigridFields to regular
        Fields, running the levels >= 1 of each group as ONE stacked ladder
        (fewer, larger kernel launches) and the finest step per field.

        partial_out: optional dict; when given, the ladder stops at level 1
        and partial_out[key] = (term0, factor0, P) with P the level-1
        partial sum -- the input contract of the MG-fused kernel.  The
        returned state then keeps those keys as MultigridFields."""
        domain = self.domain
        groups = defaultdict(list)
        for key, f in state.fields.items():
            if isinstance(f, MultigridField):
                sig = (
                    tuple(tuple(t.array.shape) for t in f.terms),
                    f.loc,
                    tuple(f.factors) if f.factors else None,
                    tuple(f.axes) if f.axes else None,
                    f.method,
                )
                groups[sig].append(key)
        groups = {sig: keys for sig, keys in groups.items() if len(keys) > 1}
        if not groups:
            return state
        new_fields = dict(state.fields)
        for keys in groups.values():
            fs = [state.fields[k] for k in keys]
            f0 = fs[0]
            nlvl = len(f0.terms)
            factors = f0.factors or domain.mg_factors or [1] * nlvl
            axes = f0.axes or domain.mg_axes
            method = f0.method or domain.mg_interp
            loc_field = "".join(l if ax else "." for l, ax in zip(f0.loc, axes))
            if nlvl < 2:
                for f, k in zip(fs, keys):
                    new_fields[k] = Field(f.terms[0].array * factors[0], loc=f0.loc)
                continue
            stacked = [torch.stack([f.terms[lvl].array for f in fs]) for lvl in range(1, nlvl)]
            acc = _horner_ladder(stacked, factors[1:], "." + loc_field, method)
            for i, (f, k) in enumerate(zip(fs, keys)):
                if partial_out is not None:
                    partial_out[k] = (f.terms[0].array, factors[0], acc[i])
                else:
                    fine = f.terms[0].array * factors[0] + interp_to_finer(acc[i], loc_field, method)
                    new_fields[k] = Field(fine, loc=f0.loc)
        return State(fields=new_fields, initialized=True)

    def loss_terms(self, arrays, tracers):
        """(arrays, tracers) -> (loss, terms, norms); terms[i] =
        mean(residual_i^2), or the raw mean for Context.Raw."""
        partials = {} if self.mg_partial else None
        state = self._flatten_multigrid_batched(self.state_from_arrays(arrays), partial_out=partials)
        ctx = Context(self.domain, state, extra=self.extra, tracers=tracers)
        ctx.mg_partials = partials or {}
        _, values = self._run_operator(ctx)
        terms = [v.value.mean() if isinstance(v, Context.Raw) else torch.mean(torch.square(v)) for v in values]
        loss = sum(terms)
        norms = [torch.sqrt(torch.clamp(t, min=0)) for t in terms]
        return loss, terms, norms

    def make_loss_fn(self, state):
        """(loss_fn, arrays0): loss_fn(arrays, tracers) -> (loss, (terms,
        norms)), differentiable by autograd with respect to ``arrays``."""
        self._capture_structure(state)
        arrays0 = self.domain.arrays_from_state(state)

        def loss_fn(arrays, tracers):
            loss, terms, norms = self.loss_terms(arrays, tracers)
            return loss, (terms, norms)

        return loss_fn, arrays0

    def make_loss_grad_fn(self, state):
        """``fn(arrays, tracers) -> ((loss, (terms, norms)), grads)``, the
        most fused route first: (1) the operator's fused multigrid pass
        (``operator.loss_and_grads`` on the level-1 partials); (2) the
        generic one-pass route for any operator whose kernel terms come
        through ``ctx.rowwise_terms``.  None when neither applies (no fused
        hook or no partials, no kernel call, a streaming call, or a dtype
        wider than 32 bits, which the kernels do not take); callers then use
        autograd of ``make_loss_fn``."""
        fn = self._make_mg_loss_grad_fn(state)
        if fn is not None:
            return fn
        return self._make_onepass_loss_grad_fn(state)

    def _make_mg_loss_grad_fn(self, state):
        fused = getattr(self.operator, "loss_and_grads", None)
        if fused is None or not self.mg_partial or np.dtype(self.domain.dtype).itemsize > 4:
            return None
        self._capture_structure(state)
        arrays0 = self.domain.arrays_from_state(state)
        probe = {}
        self._flatten_multigrid_batched(self.state_from_arrays(arrays0), partial_out=probe)
        if not probe:
            return None
        supported = getattr(fused, "supported", None)
        if supported is not None and not supported(
            tuple(tuple(v[0].shape) for v in probe.values()), self.domain.dtype
        ):
            return None
        depth = getattr(fused, "partial_depth", 1)
        if callable(depth):
            depth = depth(tuple(tuple(v[0].shape) for v in probe.values()), self.domain.dtype)
        if depth != 1:
            raise NotImplementedError("odil_torch: only partial_depth=1 is ported")
        keys = list(probe)
        factors = {k: v[1] for k, v in probe.items()}
        first, pos = {}, 0  # flat index of each field's level-0 term
        for k, f in self._template.fields.items():
            first[k] = pos
            pos += len(field_arrays(f))
        coarse = [i for i in range(pos) if i not in first.values()]  # what the partials read

        def prologue(*arrs):
            partials = {}
            self._flatten_multigrid_batched(self.state_from_arrays(arrs), partial_out=partials)
            return tuple(partials[k][2] for k in keys)

        graphed = []  # the prologue's CUDA graphs, captured at the first call on the card

        def loss_grad_fn(arrays, tracers):
            if arrays[0].is_cuda:
                if not graphed:
                    graphed.append(_GraphedPrologue(prologue, arrays, coarse))
                Ps = graphed[0].forward(arrays)
            else:
                leaves = [a.detach().requires_grad_(True) for a in arrays]
                with torch.enable_grad():
                    Ps = prologue(*leaves)
            ctx = Context(self.domain, self.state_from_arrays(arrays), extra=self.extra, tracers=tracers)
            ctx.mg_partials = {k: (arrays[first[k]].detach(), factors[k], P.detach()) for k, P in zip(keys, Ps)}
            terms, dparts = fused(ctx)
            tv = torch.stack(list(terms))
            loss, norms = tv.sum(), list(torch.sqrt(tv).unbind())
            dP = [dparts[k][1] for k in keys]
            if graphed:
                grads = graphed[0].backward(dP)
            else:
                grads = list(torch.autograd.grad(Ps, leaves, grad_outputs=dP, allow_unused=True))
            for k in keys:
                grads[first[k]] = dparts[k][0]
            grads = [torch.zeros_like(a) if g is None else g for a, g in zip(arrays, grads)]
            return (loss, (list(terms), norms)), grads

        return loss_grad_fn

    def _fine_state(self, arrays):
        """The state of ``arrays`` with every multigrid field flattened to
        its fine grid (the full Horner ladder)."""
        st = self._flatten_multigrid_batched(self.state_from_arrays(arrays))
        fields = {
            k: Field(self.domain.get_regular_array(f), loc=f.loc) if isinstance(f, MultigridField) else f
            for k, f in st.fields.items()
        }
        return State(fields=fields, initialized=True)

    def _run_deferred(self, state, tracers):
        """The operator on ``state`` with its row-wise kernel calls deferred:
        (values, recorded calls)."""
        ctx = Context(self.domain, state, extra=self.extra, tracers=tracers)
        ctx.rowwise_defer = True
        _, values = self._run_operator(ctx)
        return values, ctx.rowwise_deferred

    def _make_onepass_loss_grad_fn(self, state):
        """Generic one-pass loss+grad for any operator whose kernel terms
        come through ``ctx.rowwise_terms``.  The full multigrid flatten and
        the operator run under autograd with the kernel calls deferred
        (placeholders for their terms); each recorded call then runs the
        backward kernel with the sums on (``rowwise_loss_and_grads``: the
        terms and the cotangents of its fields and params in one sweep, no
        forward kernel), and one ``torch.autograd.grad`` folds every
        cotangent back onto the arrays: the kernels' ones, ``2 v / numel``
        for a squared non-kernel term and ``1 / numel`` for a ``Raw`` one.
        Valid because ``loss_terms`` always composes the loss as the sum of
        per-term means with fixed weights.

        On the card, when the state holds multigrid fields, the flatten and
        its vjp run as two CUDA graphs (``_GraphedPrologue`` over the
        multigrid arrays) and the autograd step covers the operator alone,
        from the fine fields and the other fields' arrays (a NeuralNet's
        weights, an ``Array``) as they are.  Kernel params that are such
        arrays (the heat model's conductivity net) take their cotangents from
        the kernel's dparams; the epoch tracer stays outside the graphs, so
        terms annealed by it change from call to call.

        Returns None when no kernel call is recorded, a call streams, or a
        call falls outside ``onepass_supported`` (64-bit dtypes)."""
        if np.dtype(self.domain.dtype).itemsize > 4:
            return None
        self._capture_structure(state)
        arrays0 = self.domain.arrays_from_state(state)
        with torch.no_grad():
            _, probe = self._run_deferred(self._fine_state(arrays0), self.tracers)
        if not probe or any(r["stream"] for r in probe):
            return None
        for r in probe:
            if not onepass_supported(r["fields"], r["params"], r["data"], r["consts"], r["nterms"], r["hist"],
                                     halox=r["halox"]):
                return None
        fields = self._template.fields
        spans, pos = {}, 0  # the flat indices of each field's arrays
        for k, f in fields.items():
            spans[k] = range(pos, pos + len(field_arrays(f)))
            pos += len(spans[k])
        mg_keys = [k for k, f in fields.items() if isinstance(f, MultigridField)]
        live = [i for k in mg_keys for i in spans[k]]  # what the flatten reads
        direct = [i for i in range(pos) if i not in live]  # the operator's own leaves (nets, arrays)

        def prologue(*arrs):
            st = self._fine_state(arrs)
            return tuple(st.fields[k].array for k in mg_keys)

        graphed = []  # the flatten's CUDA graphs, captured at the first call on the card

        def loss_grad_fn(arrays, tracers):
            use_graph = bool(mg_keys) and arrays[0].is_cuda
            if use_graph:
                if not graphed:
                    graphed.append(_GraphedPrologue(prologue, arrays, live))
                fine = [f.requires_grad_(True) for f in graphed[0].forward(arrays)]
                own = {i: arrays[i].detach().requires_grad_(True) for i in direct}
                leaves = fine + [own[i] for i in direct]
                fine_of = dict(zip(mg_keys, fine))
                st = State(
                    {
                        k: Field(fine_of[k], loc=f.loc) if k in fine_of else _rebuild(f, [own[i] for i in spans[k]])[0]
                        for k, f in fields.items()
                    },
                    initialized=True,
                )
            else:
                leaves = [a.detach().requires_grad_(True) for a in arrays]
                with torch.enable_grad():
                    st = self._fine_state(leaves)
            with torch.enable_grad():
                values, recs = self._run_deferred(st, tracers)

            outs, couts, kterms = [], [], {}
            for idx, r in enumerate(recs):
                cells = float(r["fields"][0].numel())
                sums, dfields, dparams = rowwise_loss_and_grads(
                    r["row_fn"], [x.detach() for x in r["fields"]], params=[x.detach() for x in r["params"]],
                    data=[x.detach() for x in r["data"]], consts=[x.detach() for x in r["consts"]],
                    nterms=r["nterms"], hist=r["hist"], block_rows=r["block_rows"], gscale=1.0 / cells,
                    halox=r["halox"],
                )
                means = sums / cells
                for t in range(r["nterms"]):
                    kterms[(idx, t)] = means[t]
                for x, d in zip(r["fields"] + r["params"], tuple(dfields) + tuple(dparams)):
                    if x.requires_grad:
                        outs.append(x)
                        couts.append(d)
            terms = []
            for v in values:
                if isinstance(v, Context.Raw) and getattr(v, "deferred", None) is not None:
                    terms.append(kterms[v.deferred])
                    continue
                if isinstance(v, Context.Raw):
                    v = v.value
                    term, cot = v.mean(), torch.full_like(v, 1.0 / v.numel())
                else:
                    term, cot = torch.mean(torch.square(v)), 2.0 * v.detach() / v.numel()
                terms.append(term.detach())
                if v.requires_grad:
                    outs.append(v)
                    couts.append(cot)
            dleaves = torch.autograd.grad(outs, leaves, couts, allow_unused=True) if outs else [None] * len(leaves)
            dleaves = [torch.zeros_like(a) if d is None else d for a, d in zip(leaves, dleaves)]
            if use_graph:
                grads = graphed[0].backward(dleaves[: len(mg_keys)])
                for i, d in zip(direct, dleaves[len(mg_keys) :]):
                    grads[i] = d
            else:
                grads = dleaves
            grads = [torch.zeros_like(a) if g is None else g for a, g in zip(arrays, grads)]
            tv = torch.stack(terms)
            return (tv.sum(), (terms, list(torch.sqrt(torch.clamp(tv, min=0)).unbind()))), grads

        return loss_grad_fn


class _GraphedPrologue:
    """A multigrid prologue (flat arrays -> level-1 partials for the fused
    mg route, or -> fine fields for the one-pass route) and its vjp
    (``torch.autograd.grad`` of its outputs) captured once as two CUDA graphs
    and replayed: two graph launches per step in place of some hundred small
    kernels, whose launch cost on the host set the flagship's epoch time.
    The graphs read private copies of the arrays the outputs depend on
    (``live``: the coarse levels for the partials, every array for the fine
    fields) and of the outputs' cotangents, refreshed by one multi-tensor
    copy per call."""

    def __init__(self, fn, arrays, live):
        self.live = live
        self.static = [a.detach().clone() for a in arrays]
        leaves = [self.static[i].requires_grad_(True) for i in live]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture, as make_graphed_callables does
            for _ in range(3):
                outs = fn(*self.static)
                torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs], allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, stream=side):
            self.outs = fn(*self.static)
        self.dout = [torch.empty_like(o) for o in self.outs]
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool(), stream=side):
            self.grads = torch.autograd.grad(self.outs, leaves, self.dout, allow_unused=True)

    def forward(self, arrays):
        """The partials of `arrays` (valid until the next call)."""
        with torch.no_grad():
            torch._foreach_copy_([self.static[i] for i in self.live], [arrays[i].detach() for i in self.live])
        self.fwd.replay()
        return [o.detach() for o in self.outs]

    def backward(self, dout):
        """Fresh gradients of the arrays given the partials' cotangents, None
        for the arrays the partials do not read."""
        torch._foreach_copy_(self.dout, list(dout))
        self.bwd.replay()
        out = [None] * len(self.static)
        live = [(i, g) for i, g in zip(self.live, self.grads) if g is not None]
        fresh = [torch.empty_like(g) for _, g in live]
        torch._foreach_copy_(fresh, [g for _, g in live])
        for (i, _), g in zip(live, fresh):
            out[i] = g
        return out
