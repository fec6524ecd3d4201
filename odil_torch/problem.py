"""Problem: turns a user operator into a loss and a loss-and-gradient function.

PyTorch counterpart of the parts of ``odil_tpu/problem.py`` on the flagship
path: ``loss_terms`` (:271), ``make_loss_fn`` (:293), the multigrid Horner
ladder (:49) with the level-1 partial (:129, ``partial_depth=1``) or the
level-2 one (``partial_depth=2``), and both routes of ``make_loss_grad_fn``
(:316-358): the fused multigrid route (:360-425) and the generic one-pass
route (:427-569).  Where neither
applies, ``make_loss_grad_fn`` returns None and the caller differentiates
``make_loss_fn`` with autograd, as ``bench.py:111`` does in JAX.  The
training harness's evaluations: ``eval_loss_grad`` (:571, autograd of
``loss_terms``), ``eval_operator`` (:603) and ``get_context`` (:829).  For
Newton: ``eval_operator_grad`` and ``linearize`` (:622-777, the sparse
Jacobian assembled on the host) and ``residual_fn`` (:779, the residual map
whose ``torch.func`` products the matrix-free Gauss-Newton solves with).  A
Domain with a mesh takes the halo route with ``halo=True`` (``halo.py``) and
the GSPMD route without it (``_constrain_fields``, :241).

The GSPMD route over several processes (a mesh whose positions belong to
several, ``parallel.init_distributed``) takes its arrays as each process's
blocks (``parallel.shard_state_arrays``).  Every process gathers the whole
arrays (``parallel.gather_state_arrays``; under autograd
``comm.gather_replicated``, whose backward keeps this process's block of
its own cotangent) and runs the single controller's evaluation on them,
kernels included, and keeps its block of the gradient.  The JAX kernels
know nothing of sharding either: GSPMD hands them replicated operands.
"""

import functools
import math
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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

    def __init__(self, operator, domain, extra=None, tracers=None, jit=None, remat=False, mg_partial=False):
        """
        operator: callable(ctx) returning a list of residual fields or
            (name, field) tuples; each field is an equation to drive to zero.
        domain: Domain instance.
        extra: Python payload available as ``ctx.extra``.
        tracers: dict of values visible as ``ctx.tracers``; 'epoch' defaults to 0.
        jit: accepted for the JAX package's signature and not used: PyTorch
            runs the operator eagerly either way.
        remat: recompute the operator in the backward pass of ``loss_terms``
            (``torch.utils.checkpoint``) instead of keeping its intermediates.
        mg_partial: stop the multigrid Horner flatten one level early and
            expose ``ctx.mg_partials[key] = (term0, factor0, P)`` for the
            MG-fused kernel (ops/rowwise_mg.py).
        """
        self.domain = domain
        self.operator = operator
        self.extra = extra
        self.remat = remat
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

    def _flatten_multigrid_batched(self, state, partial_out=None, partial_depth=1):
        """Flattens groups of identically-shaped MultigridFields to regular
        Fields, running the levels >= 1 of each group as ONE stacked ladder
        (fewer, larger kernel launches) and the finest step per field.

        partial_out: optional dict; when given, the ladder stops at level 1
        and partial_out[key] = (term0, factor0, P) with P the level-1
        partial sum -- the input contract of the MG-fused kernel.  With
        ``partial_depth=2`` and at least three levels it stops at level 2:
        partial_out[key] = (term0, factor0, term1, factor1, P2), the input of
        the two-level fusion (``odil_tpu/problem.py:192``).  The returned
        state then keeps those keys as MultigridFields."""
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
            stop = 2 if (partial_out is not None and partial_depth >= 2 and nlvl >= 3) else 1
            stacked = [torch.stack([f.terms[lvl].array for f in fs]) for lvl in range(stop, nlvl)]
            acc = _horner_ladder(stacked, factors[stop:], "." + loc_field, method)
            for i, (f, k) in enumerate(zip(fs, keys)):
                if partial_out is not None:
                    head = sum(((f.terms[lvl].array, factors[lvl]) for lvl in range(stop)), ())
                    partial_out[k] = head + (acc[i],)
                else:
                    fine = f.terms[0].array * factors[0] + interp_to_finer(acc[i], loc_field, method)
                    new_fields[k] = Field(fine, loc=f0.loc)
        return State(fields=new_fields, initialized=True)

    def loss_terms(self, arrays, tracers):
        """(arrays, tracers) -> (loss, terms, norms); terms[i] =
        mean(residual_i^2), or the raw mean for Context.Raw."""

        def terms_of(*arrays):
            partials = {} if self.mg_partial else None
            state = self._flatten_multigrid_batched(self.state_from_arrays(arrays), partial_out=partials)
            state = self._constrain_fields(state)
            ctx = Context(self.domain, state, extra=self.extra, tracers=tracers)
            ctx.mg_partials = partials or {}
            _, values = self._run_operator(ctx)
            return [v.value.mean() if isinstance(v, Context.Raw) else torch.mean(torch.square(v)) for v in values]

        terms = checkpoint(terms_of, *arrays, use_reentrant=False) if self.remat else terms_of(*arrays)
        loss = sum(terms)
        norms = [torch.sqrt(torch.clamp(t, min=0)) for t in terms]
        return loss, terms, norms

    def _over_processes(self):
        """Whether the GSPMD route runs over several processes (the module's
        text): a Domain whose partitioned mesh spans them."""
        mesh = self.domain.mesh
        return mesh is not None and bool(self.domain.partition) and mesh.spans_processes

    def _constrain_fields(self, state):
        """The domain's sharding constraint on every flattened fine-grid
        Field (``odil_tpu/problem.py:241``, the GSPMD route: a Domain with a
        mesh evaluated without ``halo``).  On the port's one-card mesh the
        constraint places each array on the mesh's card and changes no value,
        so the route runs the unsharded evaluation: the same kernels and the
        same bits.  No-op without a mesh or a partition."""
        domain = self.domain
        if domain.mesh is None or not domain.partition:
            return state
        fields = {
            k: Field(domain.constrain(f.array), loc=f.loc)
            if isinstance(f, Field) and f.array.ndim == domain.ndim
            else f
            for k, f in state.fields.items()
        }
        return State(fields=fields, initialized=True)

    def make_loss_fn(self, state, halo=False, extra_partition=None):
        """(loss_fn, arrays0): loss_fn(arrays, tracers) -> (loss, (terms,
        norms)), differentiable by autograd with respect to ``arrays``.

        halo=True evaluates per shard of the domain's mesh with the halo
        exchange (``halo.make_halo_loss_fn``); requires Domain(mesh=...,
        partition=...).  Without it a Domain with a mesh takes the GSPMD
        route (``_constrain_fields``)."""
        if halo:
            from .halo import make_halo_loss_fn

            return make_halo_loss_fn(self, state, extra_partition=extra_partition)
        self._capture_structure(state)
        arrays0 = self.domain.arrays_from_state(state)
        if self._over_processes():
            from .parallel import gather_state_arrays, shard_state_arrays

            shapes = [tuple(a.shape) for a in arrays0]

            def loss_fn(arrays, tracers):
                whole = gather_state_arrays(self.domain, arrays, shapes, grad=True)
                loss, terms, norms = self.loss_terms(whole, tracers)
                return loss, (terms, norms)

            return loss_fn, shard_state_arrays(self.domain, arrays0)

        def loss_fn(arrays, tracers):
            loss, terms, norms = self.loss_terms(arrays, tracers)
            return loss, (terms, norms)

        return loss_fn, arrays0

    def eval_loss_grad(self, state):
        """Loss, gradients and residual norms at `state`, by autograd of
        ``loss_terms``: (loss, grads, terms, names, norms), the loss, terms
        and norms as numpy scalars, the grads as tensors on the domain's
        device in the state's array order (over processes, the GSPMD route's
        gradient: this process's blocks)."""
        if not state.initialized:
            raise RuntimeError("Uninitialized state, use `state = domain.init_state(state)`")
        loss_fn, arrays = self.make_loss_fn(state)
        leaves = [a.detach().requires_grad_(True) for a in arrays]
        with torch.enable_grad():
            loss, (terms, norms) = loss_fn(leaves, self.tracers)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]

        def host(t):
            return t.detach().cpu().numpy()

        return host(loss), grads, [host(t) for t in terms], list(self._names), [host(n) for n in norms]

    def eval_operator(self, state):
        """The residual fields at `state`: (values, names)."""
        if not state.initialized:
            raise RuntimeError("Uninitialized state, use `state = domain.init_state(state)`")
        self._capture_structure(state)
        with torch.no_grad():
            st = self._flatten_multigrid_batched(self.state_from_arrays(self.domain.arrays_from_state(state)))
            ctx = Context(self.domain, st, extra=self.extra, tracers=self.tracers)
            _, values = self._run_operator(ctx)
        return [v.value if isinstance(v, Context.Raw) else v for v in values], list(self._names)

    def get_context(self, state):
        return Context(self.domain, state, extra=self.extra, tracers=self.tracers)

    def make_loss_grad_fn(self, state, halo=False, halo_fuse=None, extra_partition=None):
        """``fn(arrays, tracers) -> ((loss, (terms, norms)), grads)``, the
        most fused route first: (1) the operator's fused multigrid pass
        (``operator.loss_and_grads`` on the level-1 partials, or the level-2
        ones where its ``partial_depth`` asks for two levels); (2) the
        generic one-pass route for any operator whose kernel terms come
        through ``ctx.rowwise_terms``.  None when neither applies (no fused
        hook or no partials, no kernel call, a streaming call, or a dtype
        wider than 32 bits, which the kernels do not take); callers then use
        autograd of ``make_loss_fn``.

        halo=True builds the per-shard form (``halo.make_halo_loss_grad_fn``,
        ``odil_tpu/problem.py:316-340``): the generic one-pass route or, with
        ``halo_fuse="mg"`` first, the MG-fused per-shard kernel; the result
        carries the route as ``fn.route``."""
        if halo:
            from .halo import make_halo_loss_grad_fn

            return make_halo_loss_grad_fn(self, state, extra_partition=extra_partition, fuse=halo_fuse)
        fn = self._make_mg_loss_grad_fn(state)
        if fn is None:
            fn = self._make_onepass_loss_grad_fn(state)
        if fn is None or not self._over_processes():
            return fn
        # Over processes: the single controller's fused route on the whole
        # arrays, and this process's blocks of its gradient.
        from .parallel import gather_state_arrays, shard_state_arrays

        shapes = [tuple(a.shape) for a in self.domain.arrays_from_state(state)]

        def loss_grad_fn(arrays, tracers):
            out, grads = fn(gather_state_arrays(self.domain, arrays, shapes), tracers)
            return out, shard_state_arrays(self.domain, grads)

        return loss_grad_fn

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
        # Fusion depth: the operator may fuse two Horner steps (a callable
        # decides per shapes and dtype); fewer than three levels give the
        # depth-1 tuples all the same (odil_tpu/problem.py:379-394).
        depth = getattr(fused, "partial_depth", 1)
        if callable(depth):
            depth = depth(tuple(tuple(v[0].shape) for v in probe.values()), self.domain.dtype)
        if depth >= 2:
            probe = {}
            self._flatten_multigrid_batched(self.state_from_arrays(arrays0), partial_out=probe, partial_depth=2)
        keys = list(probe)
        factors = {k: v[1:-1:2] for k, v in probe.items()}  # (f0,) or (f0, f1)
        first, pos = {}, 0  # flat index of each field's level-0 term
        for k, f in self._template.fields.items():
            first[k] = pos
            pos += len(field_arrays(f))
        # The levels that join the kernel as direct inputs, and what the
        # partials read.
        direct = {k: [first[k] + lvl for lvl in range(len(factors[k]))] for k in keys}
        taken = {i for ids in direct.values() for i in ids} | set(first.values())
        coarse = [i for i in range(pos) if i not in taken]

        def prologue(*arrs):
            partials = {}
            self._flatten_multigrid_batched(self.state_from_arrays(arrs), partial_out=partials, partial_depth=depth)
            return tuple(partials[k][-1] for k in keys)

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
            ctx.mg_partials = {
                k: sum(((arrays[i].detach(), f) for i, f in zip(direct[k], factors[k])), ()) + (P.detach(),)
                for k, P in zip(keys, Ps)
            }
            terms, dparts = fused(ctx)  # dparts[k] = (dt0, dP) or (dt0, dt1, dP2)
            tv = torch.stack(list(terms))
            loss, norms = tv.sum(), list(torch.sqrt(tv).unbind())
            dP = [dparts[k][-1] for k in keys]
            if graphed:
                grads = graphed[0].backward(dP)
            else:
                grads = list(torch.autograd.grad(Ps, leaves, grad_outputs=dP, allow_unused=True))
            for k in keys:
                for i, d in zip(direct[k], dparts[k][:-1]):
                    grads[i] = d
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

    # -- Newton linearization (odil_tpu/problem.py:622-777) -----------------

    def _discover_descriptors(self, state):
        """Runs the operator once in distinct-shift mode: (names, grid
        samples, parameter unknowns), the samples as {(key, shift, loc):
        tensor} without the descriptors of MultigridFields (constants for
        Newton), the parameters as {(key, None, None): tensor or list}."""
        ctx = Context(self.domain, state, extra=self.extra, tracers=self.tracers, distinct_shift=True)
        with torch.no_grad():
            names, _ = self._run_operator(ctx)
        grid = {d: a for d, a in ctx.desc_to_array.items() if isinstance(state.fields[d[0]], Field)}
        return names, grid, dict(ctx.key_to_array_jac)

    def eval_operator_grad(self, state):
        """The residuals and their gradients with respect to the stencil
        samples: (values, grads, names).  grads[i] maps each descriptor
        (key, shift, loc) to the gradient of sum(values[i]) with respect to
        that sample (None where the term does not read it), and (key, None,
        None) to the dense Jacobian blocks of an Array or NeuralNet unknown
        (value shape + parameter shape; a list for a NeuralNet).

        The samples' gradients come from one ``torch.autograd.grad`` per
        term over the replayed operator; the parameters' blocks from one
        ``torch.func.jacfwd`` over all parameters (forward mode over the few
        parameters, where the JAX package takes reverse mode over every
        residual row)."""
        if not state.initialized:
            raise RuntimeError("Uninitialized state, use `state = domain.init_state(state)`")
        self._capture_structure(state)
        names, grid_seed, param_seed = self._discover_descriptors(state)

        def replay(grid_bindings, param_bindings):
            ctx = Context(self.domain, state, extra=self.extra, tracers=self.tracers, distinct_shift=True,
                          bindings={**grid_bindings, **param_bindings})
            _, values = self._run_operator(ctx)
            for v in values:
                assert not isinstance(v, Context.Raw), "Raw terms are not supported by Newton"
            return values

        def detached(p):
            return [a.detach() for a in p] if isinstance(p, (list, tuple)) else p.detach()

        descs = list(grid_seed)
        leaves = [grid_seed[d].detach().requires_grad_(True) for d in descs]
        params = {k: detached(p) for k, p in param_seed.items()}
        with torch.enable_grad():
            values = replay(dict(zip(descs, leaves)), params)
            grads = []
            for v in values:
                g = [None] * len(leaves)
                if v.requires_grad:
                    g = torch.autograd.grad(v.sum(), leaves, retain_graph=True, allow_unused=True)
                grads.append(dict(zip(descs, g)))
        values = [v.detach() for v in values]
        if params:
            fixed = {d: a.detach() for d, a in grid_seed.items()}
            keys = list(params)
            counts = [len(p) if isinstance(p, list) else 1 for p in params.values()]
            flat = [a for p in params.values() for a in (p if isinstance(p, list) else [p])]

            def of_params(*flat):
                bound, pos = {}, 0
                for k, n in zip(keys, counts):
                    part = list(flat[pos : pos + n])
                    bound[k] = part if isinstance(params[k], list) else part[0]
                    pos += n
                return tuple(replay(fixed, bound))

            jac = torch.func.jacfwd(of_params, argnums=tuple(range(len(flat))))(*flat)
            for i in range(len(values)):
                pos = 0
                for k, n in zip(keys, counts):
                    blocks = list(jac[i][pos : pos + n])
                    grads[i][k] = blocks if isinstance(params[k], list) else blocks[0]
                    pos += n
        return values, grads, names

    def linearize(self, state, modsp=None):
        """(V0, M): the residual vector and the global sparse Jacobian of the
        operator over the packed state vector,
            operator(V) ~= M @ (V - V0) + operator(V0),
        both on the host (numpy, scipy CSR in the domain's dtype).  The
        gradients are computed on the domain's device and copied to the host
        in one transfer; the assembly is ``odil_tpu/problem.py:688-777``'s."""
        if not state.initialized:
            raise RuntimeError("Uninitialized state, use `state = domain.init_state(state)`")
        from .parallel import refuse_processes

        refuse_processes(self.domain.mesh, "Problem.linearize (the sparse Jacobian on one host)",
                         "use the matrix-free Gauss-Newton (residual_fn, --optimizer gn)")
        if modsp is None:
            import scipy.sparse as modsp

        domain = self.domain
        t_start = time.perf_counter()
        values, grads, names = self.eval_operator_grad(state)
        values, grads = _to_host(values, grads)
        t_host = time.perf_counter()

        # Flat-vector offsets per unknown key, in pack order.
        key_to_offset, key_to_size = dict(), dict()
        offset = 0
        for key, field in state.fields.items():
            size = sum(math.prod(a.shape) for a in field_arrays(field))
            key_to_offset[key] = offset
            key_to_size[key] = size
            offset += size
        size_all = offset

        def stencil_columns(key, shift, loc, field):
            """Column indices of a shifted and relocated grid sample: the flat
            index grid carried along the sample's pad, roll and trim; padded
            entries get -1 (no unknown)."""
            cols = key_to_offset[key] + np.arange(key_to_size[key]).reshape(tuple(field.array.shape))
            pad_width = [(1, 0) if (lf == "c" and l == "n") else (0, 0) for lf, l in zip(field.loc, loc)]
            if any(w != (0, 0) for w in pad_width):
                cols = np.pad(cols, pad_width, mode="constant", constant_values=-1)
            if any(shift):
                cols = np.roll(cols, [-s for s in shift], range(domain.ndim))
            trim = [slice(0, -1) if (lf == "n" and l == "c") else slice(None) for lf, l in zip(field.loc, loc)]
            return cols[tuple(trim)]

        matrices, vectors = [], []
        for name, value, grad in zip(names, values, grads):
            nrows = math.prod(value.shape)
            mshape = (nrows, size_all)
            matrix = modsp.csr_matrix(mshape, dtype=domain.dtype)
            for desc, garray in grad.items():
                key, shift, loc = desc
                if garray is None:
                    continue
                field = state.fields[key]
                if shift is None:
                    # Array and NeuralNet unknowns: dense Jacobian blocks.
                    blocks = garray if isinstance(garray, list) else [garray]
                    dense = np.concatenate([b.reshape(nrows, -1) for b in blocks], axis=1)
                    m = modsp.csr_matrix(dense)
                    matrix = matrix + modsp.csr_matrix((m.data, m.indices + key_to_offset[key], m.indptr), shape=mshape)
                    continue
                if not isinstance(field, Field):
                    raise TypeError(f"Expected Field, got {type(field).__name__} for '{key}'")
                if not np.any(garray):
                    continue
                cols = stencil_columns(key, shift, loc, field)
                if garray.shape == value.shape:
                    rows = np.arange(nrows)
                elif value.shape == ():
                    rows = np.zeros(cols.size, dtype=int)
                else:
                    raise ValueError(
                        f"Residual '{name}' shape {value.shape} incompatible with sample shape {garray.shape}; "
                        "Newton requires pointwise terms"
                    )
                cols = cols.reshape(-1)
                data = garray.reshape(-1)
                valid = cols >= 0
                m = modsp.csr_matrix((data[valid], (rows.reshape(-1)[valid], cols[valid])), shape=mshape,
                                     dtype=domain.dtype)
                matrix = matrix + m
            matrices.append(matrix)
            vectors.append(value.reshape(-1))
        out = np.concatenate(vectors, axis=0), modsp.vstack(matrices).tocsr()
        # Seconds of the last call: the gradients (on the device, with their
        # copy to the host) and the assembly (on the host).
        self.linearize_seconds = (t_host - t_start, time.perf_counter() - t_host)
        return out

    # -- Matrix-free products (Gauss-Newton) --------------------------------

    def residual_fn(self, state, halo=False):
        """(f, x0): f(packed) -> the concatenated residual vector as a
        function of the packed unknowns, differentiable by ``torch.func``
        (``jvp``, ``vjp``) and autograd; x0 the current packed state.
        ``f.term_names`` and ``f.term_sizes`` give the terms' names and flat
        sizes, found by one evaluation.

        halo=True evaluates per shard of the domain's mesh with the halo
        exchange (``halo.make_halo_residual_fn``, ``odil_tpu/halo.py:1171``):
        the same residual map up to a fixed permutation of its rows plus
        structurally zero ghost-node rows, so the Gauss-Newton normal
        equations are unchanged."""
        if halo:
            from .halo import make_halo_residual_fn

            return make_halo_residual_fn(self, state)
        # Over several processes every process evaluates the whole map on the
        # whole packed state alike, and exchanges nothing.
        self._capture_structure(state)
        domain = self.domain
        arrays0 = domain.arrays_from_state(state)
        shapes = [tuple(a.shape) for a in arrays0]
        sizes = [math.prod(s) for s in shapes]

        def f_values(x):
            arrays = [p.reshape(s) for p, s in zip(torch.split(x, sizes), shapes)]
            st = self._constrain_fields(self._flatten_multigrid_batched(self.state_from_arrays(arrays)))
            ctx = Context(domain, st, extra=self.extra, tracers=self.tracers)
            _, values = self._run_operator(ctx)
            return [v.value if isinstance(v, Context.Raw) else v for v in values]

        def f(x):
            return torch.cat([v.reshape(-1) for v in f_values(x)])

        x0 = torch.cat([a.detach().reshape(-1) for a in arrays0])
        with torch.no_grad():
            values = f_values(x0)
        f.term_names = list(self._names)
        f.term_sizes = [int(v.numel()) for v in values]
        return f, x0


_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _to_host(values, grads):
    """The residuals and gradient blocks of ``eval_operator_grad`` as numpy
    arrays, copied from the device in one transfer of one flat buffer."""
    tensors = list(values)
    for g in grads:
        for b in g.values():
            if b is not None:
                tensors += b if isinstance(b, list) else [b]
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors]).cpu().numpy()
    parts, pos = [], 0
    for t in tensors:
        n = t.numel()
        parts.append(flat[pos : pos + n].reshape(tuple(t.shape)).astype(_NUMPY_DTYPES[t.dtype]))
        pos += n
    it = iter(parts)
    host_values = [next(it) for _ in values]
    host_grads = []
    for g in grads:
        entry = {}
        for d, b in g.items():
            if b is None:
                entry[d] = None
            elif isinstance(b, list):
                entry[d] = [next(it) for _ in b]
            else:
                entry[d] = next(it)
        host_grads.append(entry)
    return host_values, host_grads


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
