"""The halo (per-shard) evaluation path over a device mesh.

PyTorch counterpart of ``odil_tpu/halo.py``.  The JAX package evaluates the
loss inside ``shard_map``: one program per device holding one block of
every grid field, stencil shifts as slices of a halo-extended local block,
``ppermute`` rings for the halo exchange and ``psum`` for every loss sum.
The port runs one program a process over the shards that the process
owns (``_HaloPlan.local_shards``); in one process that is every shard, and
the program is a single controller that loops over them in a fixed order:

- the process holds its block of every array (in one process the whole
  array) in the storage layout of ``Domain.field_sharding``, on its device;
- each shard's local block is sliced from the process's arrays (ghost-node
  blocks of B+1 entries along node-located partitioned axes), moved to the
  shard's device, and extended by its halo from the neighbouring shards'
  blocks (``_extend_all``: the ppermute rings, with the JAX package's node
  rule, so the periodic wrap reproduces ``roll`` over N+1 nodes); a
  neighbour in another process sends its slab (``comm.ppermute``);
- autograd of those slices and concatenations is the exact scatter-add
  that JAX's transposes give, so duplicated nodes and halo cells send their
  cotangents back to the owning blocks (across processes through
  ppermute's backward);
- ``psum`` is a sum over the shards' tensors in shard order
  (``_sum_shards``; across processes the shards' values are gathered
  first, so every process adds the same numbers in the same order);
- across processes, the cotangent of an array that several processes hold
  (the whole extent of node axes, parameters) is summed over them in rank
  order (``comm.replicas``), and the coarse multigrid levels are gathered
  whole (``comm.gather``), their cotangents summed back onto the blocks.

Mesh axes that partition no grid dimension replicate every block: the
controller evaluates each distinct block once (the JAX package's psum over
the partitioning axes only, with the replicas in the counts).  Across
processes whose positions differ along such an idle axis, each process
evaluates the shards it owns, as every device along an idle axis evaluates
a replica in the JAX package: a replica is the set of processes at one
index along the idle axes (``_HaloPlan.replica_group``); the halo exchanges
pair the processes of one replica, each shard's sums enter the table once
(``comm.psum_table`` takes a row from the lowest rank that holds it), and
the cotangents are summed over the processes of one replica only, so that
every replica holds the same gradient, counted once.

The multigrid ladder runs per shard by default (``mg_ladder="local"``):
the finest level is sliced like a field, the coarser levels are whole, and
each shard prolongs only the coarse window that feeds its block through
windows of the dense interp matrices (``_mg_ladder_meta``,
``_local_mg_block``).  With ``mg_ladder="global"`` the ladder runs on the
whole grid before the shards (``Problem._fine_state``) and its fine fields
are localized like plain Fields.

Fused-kernel operators compose through ``ctx.rowwise_terms``: the kernel
runs per shard on the halo-extended blocks with a wrapped row model
(``ops/rowwise.halo_model``: global row offset, halo and duplicated-node
masking) -- on the card the masked CUDA kernels.  The one-pass loss+grad
routes of ``make_halo_loss_grad_fn`` are the generic one (deferred kernel
calls, one autograd sweep) and the MG-fused one (the local-block kernel of
``ops/rowwise_mg.py`` per shard).  On the card the localization of either
route and its vjp run as two CUDA graphs (``problem._GraphedPrologue``).

Restrictions are the JAX package's (validated at build time): partitioned
cell counts divide their mesh axis; no staggered-location conversion along
partitioned axes; grid-rank terms keep the cell or node extent along
partitioned axes; no hand-made ``Context.Raw`` terms.  Per-row data of
the local extent (auto-sharded extras, or data computed from local fields:
heat's measurements) are extended from the neighbouring shards' data once
every shard has recorded its kernel call (``_exchange_data``).

``make_halo_residual_fn`` is the per-shard residual map of Gauss-Newton
under ``--halo``: the shards' masked terms stitched into the ghost-noded
global layout, for plain operators only.
"""

import copy
import os

import numpy as np
import torch

from . import comm
from .context import Context
from .fields import Array, Field, MultigridField, NeuralNet, State, field_arrays
from .nn import eval_neural_net
from .ops.rowwise import _loss_and_grads, halo_model, rowwise_loss_sums
from .ops.rowwise_mg import _interp_matrices, rowwise_mg_local_loss_and_grads
from .parallel import shard_state_arrays
from .transfer import _interp_axis_matmul, _interp_matrix_on

__all__ = ["make_halo_loss_fn", "make_halo_loss_grad_fn", "make_halo_residual_fn", "refuse_plane_partition"]


def refuse_plane_partition(ctx, what):
    """Raises for a shard's context (``_HaloContext``) whose plane axes are
    partitioned: for row models that place their walls by the plane index
    (heat, wave), whose residuals a shard's own index would move to the
    seams.  The JAX package raises for wave there and gives heat another loss
    than its unsharded one (365.63 against 370.04 at 16^2 on t:2,x:2, the
    same random state)."""
    plan = getattr(ctx, "plan", None)
    if plan is not None and any(d > 0 for d in plan.dim_axis):
        raise ValueError(f"{what} under --halo takes a partition of t only, got {plan.domain.partition}")


class _Shard:
    """One distinct block of the mesh: its index along each partitioning
    axis (``key``, in the plan's axis order), its device, the process that
    owns it and its number in shard order."""

    def __init__(self, index, key, device, owner=0, number=0):
        self.index, self.key, self.device = index, key, device
        self.owner, self.number = owner, number

    def __repr__(self):
        return f"_Shard({self.index}, {self.device})"


def _local_block(a, plan, shard, loc, dims=None, start=None):
    """Shard's block of the array ``a``: along each partitioned grid
    dimension (``dims``: {array dim: grid dim}, default the identity) the
    cells [i*B, (i+1)*B), or the ghost-node block [i*B, i*B+B] on a node
    axis; moved to the shard's device.  ``a`` is the global array, or with
    ``start`` (the first global index of ``a`` along each array dimension)
    a process's block of it."""
    dims = dims if dims is not None else {d: d for d in range(a.ndim)}
    for j, d in dims.items():
        axis = plan.dim_axis.get(d)
        if axis is None:
            continue
        B = plan.domain.cshape[d] // plan.axis_sizes[axis]
        i = shard.index[axis]
        a = a.narrow(j, i * B - (start[j] if start else 0), B + (1 if loc[j] == "n" else 0))
    return a.to(shard.device)


def _extend_all(blocks, plan, widths, loc, dims=None):
    """Extends every shard's block by per-dimension halo widths along every
    partitioned dimension, from its ring neighbours' blocks (the ppermute
    pairs of ``odil_tpu/halo.py:_extend_array``, one dimension after the
    other, so corners come from the diagonal neighbour).

    Cell axes: the neighbour's edge rows ARE the halo.  Node axes (ghost-node
    blocks of B+1 rows sharing one node with each neighbour): the slab is one
    row wider and each receiver drops the shared node -- interior receivers
    take [0:h] (leading) / [1:h+1] (trailing), the ring-wrap receivers shift
    by one, matching periodic indexing modulo N+1.  A neighbour absent from
    ``blocks`` lives in another process, which sends its slab
    (``_remote_slabs``).

    blocks: {shard key: tensor}; returns the same keys, extended."""
    return _extend_many(plan, [(blocks, widths, loc, dims)])[0]


def _extend_many(plan, items):
    """``_extend_all`` of several arrays' blocks, ``items`` [(blocks, widths,
    loc, dims)], in lockstep: the n-th dimension of every item, then the
    next, with one ``comm.ppermute`` a step for the slabs of all items that
    cross processes.  Each item's operations are those of it alone."""
    items = [(blocks, widths, loc, list((dims if dims is not None else {d: d for d in range(len(loc))}).items()))
             for blocks, widths, loc, dims in items]
    out = [blocks for blocks, *_ in items]
    for step in range(max(len(dims) for *_, dims in items)):
        steps, sends, recvs, keys = {}, [], [], []
        for n, (_, widths, loc, dims) in enumerate(items):
            if step >= len(dims):
                continue
            j, d = dims[step]
            axis = plan.dim_axis.get(d)
            if axis is None:
                continue
            lo, hi = widths[j]
            if not (lo or hi):
                continue
            node = loc[j] == "n"
            k, pos = plan.axis_sizes[axis], plan.axis_pos[axis]
            wlo, whi = (lo + (1 if node else 0) if lo else 0), (hi + (1 if node else 0) if hi else 0)
            steps[n] = (j, lo, hi, k, pos, node, wlo, whi)
            _remote_slabs(out[n], plan, n, steps[n], sends, recvs, keys)
        remote = dict(zip(keys, comm.ppermute(sends, recvs, plan.chain))) if (sends or recvs) else {}
        for n, (j, lo, hi, k, pos, node, wlo, whi) in steps.items():
            blocks = out[n]
            ext = {}
            for key, a in blocks.items():
                i = key[pos]

                def neighbour(step):
                    return blocks.get(_moved(key, pos, (i + step) % k))

                parts = []
                if lo:
                    prev = neighbour(-1)
                    if prev is None:
                        slab = remote[(n, key, -1)]
                    else:
                        m, w = prev.shape[j], wlo
                        slab = prev.narrow(j, m - w, w)
                    if node:
                        slab = slab.narrow(j, 1 if i == 0 else 0, lo)
                    parts.append(slab.to(a.device))
                parts.append(a)
                if hi:
                    nxt = neighbour(1)
                    slab = remote[(n, key, 1)] if nxt is None else nxt.narrow(j, 0, whi)
                    if node:
                        slab = slab.narrow(j, 0 if i == k - 1 else 1, hi)
                    parts.append(slab.to(a.device))
                ext[key] = torch.cat(parts, dim=j) if len(parts) > 1 else a
            out[n] = ext
    return out


def _moved(key, pos, i):
    """``key`` with its entry ``pos`` set to ``i``."""
    nk = list(key)
    nk[pos] = i
    return tuple(nk)


def _remote_slabs(blocks, plan, n, step, sends, recvs, keys):
    """The halo slabs of item ``n``'s blocks along one step (array dimension
    ``j``, mesh axis position ``pos`` of ``k`` shards) whose ring neighbour
    lives in another process: each block sends its trailing ``wlo`` rows to
    the next shard and its leading ``whi`` rows to the previous one, where
    those are remote.  Appends to ``sends`` and ``recvs`` (``comm.ppermute``'s
    lists, tags unique among the items) and to ``keys`` (n, shard key, -1 or
    1): the slab that the shard receives from its previous (-1) or next (1)
    neighbour, untrimmed, as ``_extend_many`` slices it from a local one."""
    j, _, _, k, pos, _, wlo, whi = step
    base = 2 * len(plan.shards) * n
    for key, a in blocks.items():
        i = key[pos]
        prv, nxt = _moved(key, pos, (i - 1) % k), _moved(key, pos, (i + 1) % k)
        for w, which, to, frm, side, first in ((wlo, 0, nxt, prv, -1, a.shape[j] - wlo), (whi, 1, prv, nxt, 1, 0)):
            if not w:
                continue
            if to not in blocks:
                sends.append((plan.owner[to], base + plan.tag(key, which), a.narrow(j, first, w)))
            if frm not in blocks:
                shape = list(a.shape)
                shape[j] = w
                recvs.append((plan.owner[frm], base + plan.tag(frm, which), tuple(shape), a.dtype, a.device))
                keys.append((n, key, side))


def _plain_term_mask(plan, shard, v, ti):
    """0/1 ownership mask (or None) and the GLOBAL residual count of one
    non-kernel term of a shard (``odil_tpu/halo.py:125``, the count over
    distinct blocks: the convention of the kernel terms).

    Grid-rank terms: along each partitioned dimension the local extent must
    be the cell block B or the ghost-node block B+1 (anything else means the
    operator sliced the term along a partitioned dimension); the duplicated
    shared node is masked out (the left shard owns it).  Non-grid terms are
    replicated on every shard; their count absorbs the shard count."""
    domain = plan.domain
    mask = None
    if v.ndim == domain.ndim:
        count = 1.0
        for d in range(domain.ndim):
            s = v.shape[d]
            axis = plan.dim_axis.get(d)
            if axis is None:
                count *= s
                continue
            k = plan.axis_sizes[axis]
            B = domain.cshape[d] // k
            if s == B:
                count *= B * k
            elif s == B + 1:
                count *= B * k + 1
                if k > 1:
                    m = (torch.arange(s, device=v.device) > 0) | (shard.index[axis] == 0)
                    mshape = [1] * domain.ndim
                    mshape[d] = s
                    m = m.reshape(mshape).to(v.dtype)
                    mask = m if mask is None else mask * m
            else:
                raise ValueError(
                    f"halo mode: term {ti} ('{plan.names[ti]}') has local "
                    f"extent {s} along partitioned dimension "
                    f"'{domain.dimnames[d]}' (expected the cell block {B} "
                    f"or node block {B + 1}); operators must not slice "
                    f"terms along partitioned dimensions"
                )
    else:
        count = float(np.prod(tuple(v.shape))) * len(plan.shards)
    return mask, count


def _local_extra_of(extra, extra_arrs):
    """The shard-local ``ctx.extra``: the global extra object with its
    planned array attributes replaced by the shard's blocks."""
    if extra is None:
        return None
    if isinstance(extra, dict):
        out = dict(extra)
        out.update(extra_arrs)
        return out
    out = copy.copy(extra)
    for k, v in extra_arrs.items():
        setattr(out, k, v)
    return out


def _mg_ladder_meta(domain, plan, key, mgfield):
    """Static metadata of the local multigrid ladder (``odil_tpu/halo.py:234``):
    per level the array shapes and, per partitioned dimension, the window
    size (None = the whole axis); the factors, active axes and locations."""
    factors = mgfield.factors or domain.mg_factors or [1] * len(mgfield.terms)
    axes = mgfield.axes or domain.mg_axes
    loc = mgfield.loc
    ndim = domain.ndim
    shapes = [tuple(t.array.shape) for t in mgfield.terms]
    nlvl = len(shapes)
    active = [bool(ax) and loc[d] != "." for d, ax in enumerate(axes)]
    sizes = []
    s0 = []
    for d in range(ndim):
        if d in plan.dim_axis:
            B = domain.cshape[d] // plan.axis_sizes[plan.dim_axis[d]]
            s0.append(B + (1 if loc[d] == "n" else 0))
        else:
            s0.append(None)
    sizes.append(tuple(s0))
    for lvl in range(1, nlvl):
        prev = sizes[-1]
        cur = []
        for d in range(ndim):
            if prev[d] is None:
                cur.append(None)
            elif active[d]:
                w = prev[d] // 2 + 3
                cur.append(None if w >= shapes[lvl][d] else w)
            else:
                cur.append(None if prev[d] >= shapes[lvl][d] else prev[d])
        sizes.append(tuple(cur))
    return {"factors": [float(f) for f in factors], "loc": loc, "active": active, "shapes": shapes, "sizes": sizes}


def _local_mg_block(plan, shard, meta, levels):
    """The Horner ladder ``u = s0 + I(s1 + I(s2 + ...))`` for one shard's
    block (``odil_tpu/halo.py:305``): ``levels[0]`` is the shard's
    (ghost-noded) block of the finest term, ``levels[1:]`` the whole coarser
    terms on the shard's device.  Windows along partitioned dimensions start
    at the shard's offsets and are prolonged through windows of the dense
    interp matrices; active unpartitioned dimensions take the whole matrix."""
    domain = plan.domain
    ndim = domain.ndim
    nlvl = len(levels)
    shapes, sizes = meta["shapes"], meta["sizes"]
    active, factors, loc = meta["active"], meta["factors"], meta["loc"]
    starts = [{d: shard.index[axis] * (domain.cshape[d] // plan.axis_sizes[axis]) for d, axis in plan.dim_axis.items()}]
    for lvl in range(1, nlvl):
        prev, cur = starts[-1], {}
        for d in plan.dim_axis:
            w = sizes[lvl][d]
            if w is None:
                cur[d] = 0
            elif active[d]:
                cur[d] = min(max(prev[d] // 2 - 1, 0), shapes[lvl][d] - w)
            else:
                cur[d] = prev[d]
        starts.append(cur)

    def window(a, lvl):
        for d in plan.dim_axis:
            w = sizes[lvl][d]
            if w is not None:
                a = a.narrow(d, starts[lvl][d], w)
        return a

    acc = window(levels[-1], nlvl - 1) * factors[nlvl - 1]
    for lvl in range(nlvl - 2, -1, -1):
        for d in range(ndim):
            if not active[d]:
                continue
            w_out, w_in = sizes[lvl][d], sizes[lvl + 1][d]
            if d in plan.dim_axis and (w_out is not None or w_in is not None):
                M = _interp_matrix_on(shapes[lvl + 1][d], loc[d], acc.dtype, acc.device)
                if w_out is not None:
                    M = M.narrow(0, starts[lvl][d], w_out)
                if w_in is not None:
                    M = M.narrow(1, starts[lvl + 1][d], w_in)
                acc = torch.movedim(torch.matmul(torch.movedim(acc, d, -1), M.T), -1, d)
            else:
                acc = _interp_axis_matmul(acc, d, loc[d])
        lv = levels[lvl] if lvl == 0 else window(levels[lvl], lvl)
        acc = lv * factors[lvl] + acc
    return acc


class _HaloPlan:
    """Static plan built once per (problem, state): which dimensions are
    partitioned, the distinct shards and those of this process, per-field
    halo widths, the extra arrays' localization, the term names
    (``odil_tpu/halo.py:385``), and across processes the storage of each
    array (``inputs``)."""

    def __init__(self, problem, state, extra_partition=None):
        domain = problem.domain
        if domain.mesh is None or not domain.partition:
            raise ValueError("halo mode requires Domain(mesh=..., partition=...)")
        self.domain = domain
        self.mesh = domain.mesh
        self.axis_sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        # dim index -> mesh axis name, for partitioned dims only.
        self.dim_axis = {
            d: domain.partition[name] for d, name in enumerate(domain.dimnames) if domain.partition.get(name)
        }
        # The partitioning axes, in mesh order; a shard is one block of them.
        self.used_axes = tuple(a for a in self.mesh.axis_names if a in set(self.dim_axis.values()))
        self.axis_pos = {a: p for p, a in enumerate(self.used_axes)}
        # Across processes: this process's shards, on its device; the sums go
        # through the group whenever one spans the mesh's processes.  The
        # owner of a shard is the process that holds its position in this
        # process's replica (its index along the idle axes).
        self.spmd = self.mesh.spans_processes
        replicas = {r: self._replica_of(r) for r in self.mesh.processes}
        me = self.mesh.process
        self.replica_group = [r for r in self.mesh.processes if replicas[r] == replicas[me]]
        self.shards = []
        for n, key in enumerate(np.ndindex(*[self.axis_sizes[a] for a in self.used_axes])):
            index = dict(zip(self.used_axes, (int(i) for i in key)))
            self.shards.append(_Shard(index, tuple(int(i) for i in key), self.mesh.device_at(index),
                                      self.mesh.owner_at(dict(replicas[me], **index)), n))
        self.local_shards = [s for s in self.shards if s.owner == me]
        self.owner = {s.key: s.owner for s in self.shards}
        self.number = {s.key: s.number for s in self.shards}
        self.reduces = comm.initialized() and len(self.mesh.processes) == comm.world_size()
        self.process_shards = [[s.number for s in self.shards if self.mesh.owner_at(dict(replicas[r], **s.index)) == r]
                               for r in self.mesh.processes]
        self.first = self.mesh.local_device
        self.names, self.locs, self.widths, self.param_keys = self._discover(problem, state)
        self._validate(problem, state)
        # Extra arrays with a node-sized partitioned axis: {name: {array_dim: grid dim}}.
        self.extra_dims = {}
        self.extra_locs = {}
        self._plan_extra(problem, extra_partition)
        self._masks = {}
        self._extras = {}
        self._plan_storage(state)
        # The order of the backward's collectives; each evaluation starts a
        # new chain (``comm.Chain``).
        self.chain = comm.Chain()

    def _replica_of(self, process):
        """{idle axis: first index} of ``process``'s positions along the mesh
        axes that partition no grid dimension: the processes of one replica
        share it.  ValueError unless every process's positions span the same
        count along each such axis, aligned to it (then each replica holds
        every shard exactly once)."""
        idle = [a for a in self.mesh.axis_names if a not in self.used_axes]
        if not self.mesh.spans_processes:
            return dict.fromkeys(idle, 0)
        boxes = {r: self.mesh.box(r) for r in self.mesh.processes}
        for a in idle:
            counts = {boxes[r][a][1] for r in boxes}
            if len(counts) > 1 or any(boxes[r][a][0] % boxes[r][a][1] for r in boxes):
                raise ValueError(
                    f"halo mode over several processes: the processes' positions along mesh axis {a!r}, which "
                    f"partitions no grid dimension, are not blocks of one size: "
                    f"{ {r: boxes[r][a] for r in boxes} }"
                )
        return {a: boxes[process][a][0] for a in idle}

    def every_shard(self):
        """Every shard of the mesh, in shard order, on this process's device:
        the blocks that a process holding the whole arrays slices for the
        shards of others (``_localize(..., every=True)``)."""
        return [s if s.owner == self.mesh.process else _Shard(s.index, s.key, self.first, s.owner, s.number)
                for s in self.shards]

    def tag(self, key, which):
        """The tag of shard ``key``'s slab ``which`` (0: its trailing rows, 1:
        its leading rows) in one exchange."""
        return 2 * self.number[key] + which

    # -- Storage across processes ---------------------------------------------

    def _plan_storage(self, state):
        """Each flat array's role across processes: ``"block"`` (a Field, or
        the finest level of a multigrid field: sliced into shards from this
        process's block, its cotangent summed over the processes that hold
        the same block), ``"whole"`` (a coarser level: gathered whole) or
        ``"param"`` (held whole by every process); and ``starts``, the first
        global index of this process's block of each field's (finest)
        array.  In one process nothing is planned: the arrays are whole."""
        self.starts = {}
        self.storage = []
        if not self.spmd:
            return
        domain = self.domain
        ranks = list(self.mesh.processes)
        replica = self.replica_group
        for key, f in state.fields.items():
            arrs = field_arrays(f)
            if isinstance(f, Field):
                kinds = ["block"]
            elif isinstance(f, MultigridField):
                kinds = ["block"] + ["whole"] * (len(arrs) - 1)
            else:
                kinds = ["param"] * len(arrs)
            for n, (kind, a) in enumerate(zip(kinds, arrs)):
                shape = tuple(a.shape)
                if kind == "param" or a.ndim != domain.ndim:
                    self.storage.append(("param", shape, None, replica))
                    continue
                sharding = domain.field_sharding(shape=shape)
                regions = [sharding.region(shape, r) for r in ranks]
                mine = regions[ranks.index(self.mesh.process)]
                if n == 0:
                    self.starts[key] = tuple(lo for lo, _ in mine)
                group = [r for r, reg in zip(ranks, regions) if reg == mine and r in replica]
                self.storage.append((kind, shape, regions, group))

    def inputs(self, arrays, global_ladder=False, kinds=("block", "whole", "param")):
        """This process's arrays as the shards read them (``kinds``: the
        roles to take; the others pass as they are): across processes the
        "block" arrays as they are but for the sum of their cotangents over
        the processes that hold the same block, the "whole" ones (with
        ``global_ladder`` every grid array) gathered whole, the parameters
        with their cotangents summed over every process.  In one process the
        arrays themselves."""
        if not self.spmd:
            return list(arrays)
        out = list(arrays)
        # One exchange for the gathered arrays, one for each replica group.
        batches = {}
        for i, (kind, shape, regions, group) in enumerate(self.storage):
            if kind not in kinds:
                continue
            gathered = kind == "whole" or (global_ladder and kind == "block")
            batches.setdefault(("gather",) if gathered else ("replicas", tuple(group)), []).append(i)
        for key, idx in batches.items():
            xs = [arrays[i] for i in idx]
            if key[0] == "gather":
                got = comm.gather(xs, [(self.storage[i][2], self.storage[i][1]) for i in idx], self.chain,
                                  group=self.replica_group)
            else:
                got = comm.replicas(xs, list(key[1]), self.chain)
            for i, x in zip(idx, got):
                out[i] = x
        return out

    # -- Discovery -----------------------------------------------------------

    def _discover(self, problem, state):
        """Runs the operator once on the global state (kernel calls
        deferred) to learn every (key, shift, loc) stencil read, the
        parameter unknowns and the term names."""
        domain = self.domain
        problem._capture_structure(state)
        arrays0 = domain.arrays_from_state(state)
        with torch.no_grad():
            st = problem._fine_state(arrays0)
            ctx = Context(domain, st, extra=problem.extra, tracers=problem.tracers)
            ctx.rowwise_defer = True
            names, values = problem._run_operator(ctx)
        if any(isinstance(v, Context.Raw) and not getattr(v, "from_rowwise", False) for v in values):
            raise ValueError(
                "halo mode does not support hand-made Context.Raw terms; "
                "evaluate fused kernels through ctx.rowwise_terms (sharded "
                "automatically) or use the plain operator (kernel='xla')"
            )
        self.rowwise_calls = list(ctx.rowwise_calls)
        self.streams = any(r["stream"] for r in ctx.rowwise_deferred)
        locs, widths, param_keys = {}, {}, []
        for key, f in st.fields.items():
            if isinstance(f, Field):
                locs[key] = f.loc
                widths[key] = [[0, 0] for _ in range(domain.ndim)]
            else:
                param_keys.append(key)
        for key, shift, loc in ctx.desc_to_array:
            if key not in widths:
                continue
            floc = locs[key]
            for d, s in enumerate(shift):
                if d in self.dim_axis:
                    if loc[d] != floc[d]:
                        raise ValueError(
                            f"halo mode: field '{key}' read at loc '{loc}' but stored at "
                            f"'{floc}'; staggered retargeting along the partitioned "
                            f"dimension '{domain.dimnames[d]}' is unsupported"
                        )
                    widths[key][d][0] = max(widths[key][d][0], max(0, -s))
                    widths[key][d][1] = max(widths[key][d][1], max(0, s))
        # Kernel operators: the declared reaches size the exchanges -- `hist`
        # rows back along t, `halox` both ways along partitioned plane axes.
        for call in self.rowwise_calls:
            for key in call["keys"]:
                if key not in widths:
                    raise ValueError(f"halo mode: rowwise_terms key '{key}' is not a grid field")
                floc = locs[key]
                for d in range(domain.ndim):
                    if d not in self.dim_axis:
                        continue
                    if d == 0:
                        widths[key][0][0] = max(widths[key][0][0], call["hist"])
                        continue
                    if floc[d] != "c":
                        raise ValueError(
                            "halo mode: kernel operators require cell-located "
                            "plane axes along partitioned dimensions"
                        )
                    widths[key][d][0] = max(widths[key][d][0], call["halox"])
                    widths[key][d][1] = max(widths[key][d][1], call["halox"])
        return names, locs, widths, param_keys

    def _validate(self, problem, state):
        domain = self.domain
        st = problem._fine_state(domain.arrays_from_state(state))
        for key, f in st.fields.items():
            if not isinstance(f, Field):
                continue
            shape = tuple(f.array.shape)
            for d, axis in self.dim_axis.items():
                k = self.axis_sizes[axis]
                cells = shape[d] - 1 if self.locs[key][d] == "n" else shape[d]
                if cells % k != 0:
                    raise ValueError(
                        f"halo mode: field '{key}' has {cells} cells along partitioned "
                        f"dimension '{domain.dimnames[d]}', not divisible by mesh axis "
                        f"'{axis}' ({k} devices); drop that axis from the partition"
                    )
                lo, hi = self.widths[key][d]
                if lo + hi >= cells // k:
                    raise ValueError(
                        f"halo mode: stencil width ({lo}+{hi}) along "
                        f"'{domain.dimnames[d]}' exceeds the local block "
                        f"({cells}//{k}); use fewer devices on that axis"
                    )

    def _plan_extra(self, problem, extra_partition):
        """Which array-valued ``extra`` attributes are localized: arrays whose
        shape matches a trailing run of grid axes take those axes'
        partition (``extra_partition`` overrides: dimension names, or None
        to keep the array whole).  Fills ``extra_dims`` ({name: {array dim:
        grid dim}}) and ``extra_locs``."""
        domain = self.domain
        extra = problem.extra
        if extra is None:
            return
        items = vars(extra) if not isinstance(extra, dict) else extra
        for name, value in items.items():
            if not torch.is_tensor(value) and not isinstance(value, np.ndarray):
                continue
            if value.ndim == 0:
                continue
            if extra_partition is not None and name in extra_partition:
                dims = extra_partition[name]
                if dims is not None:
                    self.extra_dims[name] = {i: domain.dimnames.index(n) for i, n in enumerate(dims)}
                    self.extra_locs[name] = "c" * value.ndim
                continue
            offset = domain.ndim - value.ndim
            if offset < 0:
                continue
            dims, loc, matched = {}, "", True
            for j, s in enumerate(tuple(value.shape)):
                d = offset + j
                if s not in (domain.cshape[d], domain.cshape[d] + 1):
                    matched = False
                    break
                loc += "n" if s == domain.cshape[d] + 1 else "c"
                axis = self.dim_axis.get(d)
                if axis is not None:
                    cells = s - 1 if loc[-1] == "n" else s
                    if cells % self.axis_sizes[axis] != 0:
                        raise ValueError(
                            f"halo mode: extra array '{name}' has size {s} along "
                            f"partitioned dimension '{domain.dimnames[d]}', not "
                            f"divisible; pass extra_partition={{'{name}': None}} to "
                            f"replicate it"
                        )
                    dims[j] = d
            if matched:
                self.extra_dims[name] = dims
                self.extra_locs[name] = loc

    def local_extra(self, problem, shard):
        """The shard's ``ctx.extra``: the planned arrays sliced to its block,
        made once (numpy arrays become tensors on the shard's device, as the
        JAX package places them once at build time)."""
        extra = problem.extra
        if extra is None:
            return None
        if not self._extras:
            items = vars(extra) if not isinstance(extra, dict) else extra
            whole = {name: torch.as_tensor(items[name], device=self.first) for name in self.extra_dims}
            for s in self.local_shards:
                arrs = {n: _local_block(v, self, s, self.extra_locs[n], self.extra_dims[n]) for n, v in whole.items()}
                self._extras[s.key] = _local_extra_of(extra, arrs)
        return self._extras[shard.key]

    def local_shape(self, key):
        """The shape of a grid field's local (ghost-noded) block."""
        shape = []
        for d in range(self.domain.ndim):
            n = self.domain.cshape[d] + (1 if self.locs[key][d] == "n" else 0)
            axis = self.dim_axis.get(d)
            if axis is not None:
                n = self.domain.cshape[d] // self.axis_sizes[axis] + (1 if self.locs[key][d] == "n" else 0)
            shape.append(n)
        return tuple(shape)

    def plane_mask(self, shard, pshape, widths, dtype):
        """The 0/1 plane mask of an extended block: zero on the halo columns
        of partitioned plane axes (cached per shard and geometry)."""
        key = (shard.key, tuple(pshape), tuple(tuple(w) for w in widths), dtype)
        m = self._masks.get(key)
        if m is None:
            m = torch.ones(pshape, dtype=dtype, device=shard.device)
            for d, (lo, hi) in enumerate(widths):
                if not (lo or hi):
                    continue
                n = pshape[d]
                r = torch.arange(n, device=shard.device)
                mshape = [1] * len(pshape)
                mshape[d] = n
                m = m * ((r >= lo) & (r < n - hi)).reshape(mshape).to(dtype)
            self._masks[key] = m
        return m


def _localize(problem, plan, mg_meta, arrays, global_ladder=False, every=False):
    """Every local shard's grid blocks and parameter unknowns from the
    arrays as ``plan.inputs`` gives them: ``({key: {shard key: block}},
    {shard key: {key: Array or NeuralNet}})``.  Multigrid fields run the
    local ladder, or with ``global_ladder`` are flattened on the whole grid
    first and sliced like plain Fields.  Differentiable.  The counterpart of
    the JAX package's ``_halo_global_inputs`` (:1031, the ghost-node layout)
    and ``_local_grid_params`` (:1003, the local ladder and the parameters'
    regrouping) together.

    every=True: ``arrays`` are the whole arrays, and the blocks of every
    shard of the mesh are sliced from them (``plan.every_shard``), so that
    extending them needs no exchange."""
    shards = plan.every_shard() if every else plan.local_shards
    st = problem._fine_state(arrays) if global_ladder else problem.state_from_arrays(arrays)
    grid, params = {}, {s.key: {} for s in shards}
    for key, f in st.fields.items():
        start = None if (global_ladder or every) else plan.starts.get(key)
        if isinstance(f, Field):
            grid[key] = {s.key: _local_block(f.array, plan, s, plan.locs[key], start=start) for s in shards}
        elif isinstance(f, MultigridField):
            levels = [t.array for t in f.terms]
            grid[key] = {}
            for s in shards:
                local = [_local_block(levels[0], plan, s, plan.locs[key], start=start)]
                local += [lv.to(s.device) for lv in levels[1:]]
                grid[key][s.key] = _local_mg_block(plan, s, mg_meta[key], local)
        else:
            for s in shards:
                params[s.key][key] = _param_on(f, s.device)
    return grid, params


def _sum_shards(plan, values):
    """The sum over every shard of the mesh, in shard order, of ``values``
    (one tensor of one shape a local shard, in shard order): the psum.
    Where a process group spans the mesh's processes the shards' values are
    gathered first (``comm.psum_table``), so every process folds the same
    numbers in the same order; in one process without a group the local
    values are folded as they are.  Either way the same fold."""
    if plan.reduces:
        values = comm.psum_table(torch.stack(values), plan.process_shards, len(plan.shards)).unbind(0)
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    return acc


def _param_on(f, device):
    """A parameter unknown (Array or NeuralNet) with its arrays on ``device``."""
    if isinstance(f, Array):
        return Array(f.array.to(device), shape=f.shape)
    return NeuralNet([w.to(device) for w in f.weights], [b.to(device) for b in f.biases])


class _HaloContext:
    """Context lookalike of one shard (``odil_tpu/halo.py:587``).

    ``field`` resolves stencil reads by slicing the halo-extended block of
    the field (one exchange per field, shared by all its shifts);
    ``indices``/``points`` return the GLOBAL coordinate values of the block.
    exts: {key: this shard's extended block}."""

    Raw = Context.Raw

    def __init__(self, plan, shard, exts, params, extra, tracers):
        domain = plan.domain
        self.plan = plan
        self.shard = shard
        self.domain = domain
        self.mod = domain.mod
        self.dtype = domain.dtype
        self.extra = extra
        self.tracers = tracers
        self.step = domain.step
        self.size = domain.size
        self._exts = exts
        self._params = params
        self.state = State(fields=dict(params), initialized=True)
        self.mg_partials = {}
        self._cache = {}
        self.rowwise_deferred = []

    def cast(self, value, dtype=None):
        return self.mod.cast(value, dtype or self.dtype)

    def _extend(self, key):
        return self._exts[key]

    # -- Context API ---------------------------------------------------------

    def field(self, key, *shift, loc=None, frozen=False):
        mod = self.mod
        ndim = self.domain.ndim
        if key in self._params:
            f = self._params[key]
            if not isinstance(f, Array):
                raise TypeError(f"Expected Field or Array, got {type(f).__name__} for '{key}'")
            if len(shift):
                raise RuntimeError("Array requires an empty shift")
            return f.array.detach() if frozen else f.array
        if key not in self.plan.locs:
            raise KeyError(f"Unknown field '{key}'")
        shift = tuple(shift) or (0,) * ndim
        if len(shift) != ndim:
            raise RuntimeError(f"Expected {ndim} shift components, got shift={shift}")
        floc = self.plan.locs[key]
        loc = loc or floc
        desc = (key, shift, loc)
        array = self._cache.get(desc)
        if array is None:
            array = self._extend(key)
            local_shape = self.plan.local_shape(key)
            for d in self.plan.dim_axis:
                lo, _ = self.plan.widths[key][d]
                array = array.narrow(d, lo + shift[d], local_shape[d])
            pad_width = [
                (1, 0) if (lf == "c" and l == "n" and d not in self.plan.dim_axis) else (0, 0)
                for d, (lf, l) in enumerate(zip(floc, loc))
            ]
            if any(w != (0, 0) for w in pad_width):
                array = mod.pad(array, pad_width=pad_width, mode="constant")
            roll_shift = [-shift[d] if d not in self.plan.dim_axis else 0 for d in range(ndim)]
            if any(roll_shift):
                array = mod.roll(array, roll_shift, range(ndim))
            trim = [
                slice(0, -1) if (lf == "n" and l == "c" and d not in self.plan.dim_axis) else slice(None)
                for d, (lf, l) in enumerate(zip(floc, loc))
            ]
            if any(s != slice(None) for s in trim):
                array = array[tuple(trim)]
            self._cache[desc] = array
        return array.detach() if frozen else array

    def rowwise_terms(
        self, row_fn, keys, params=(), data=(), consts=(), nterms=1, hist=1, halox=1, block_rows=None,
        stream=False,
    ):
        """The per-shard form of ``Context.rowwise_terms``
        (``odil_tpu/halo.py:746``): the row-wise kernel on this shard's
        halo-extended blocks with a wrapped row model (global row offset,
        halo rows and columns and the duplicated ghost node masked out).
        The call is recorded in ``rowwise_deferred`` and the terms are
        placeholders carrying ``deferred = (call, term)``: shard-local data
        are extended only once every shard has recorded its call
        (``_exchange_data``), and the caller runs the kernels then."""
        plan = self.plan
        domain = self.domain
        ndim = domain.ndim
        shard = self.shard
        keys = tuple(keys)
        w0 = plan.widths[keys[0]]
        loc0 = plan.locs[keys[0]]
        for k in keys[1:]:
            if plan.widths[k] != w0 or plan.locs[k] != loc0:
                raise ValueError(
                    "halo mode: rowwise_terms fields must share one halo "
                    f"plan; '{keys[0]}' and '{k}' differ (are they also read "
                    "through ctx.field with different shifts?)"
                )
        exts = tuple(self._extend(k) for k in keys)
        local_shape = plan.local_shape(keys[0])
        dtype = exts[0].dtype

        def _localize_data(darr):
            # Per-row data are brought to the halo-extended local shape of the
            # fields (``odil_tpu/halo.py``'s ``_localize_data``): global-shaped
            # dims are sliced to each shard's block, size-1 plane dims
            # broadcast, and the halo comes from the neighbouring shards.
            # Global-shaped data are extended here, from every shard's block
            # of the global array; shard-local data (auto-sharded extras, or
            # data computed from local fields) once every shard has recorded
            # its call (``_exchange_data``): (tensor or None, pending or None).
            darr = torch.as_tensor(darr, device=shard.device)
            if darr.ndim != ndim:
                raise ValueError(
                    f"halo mode: rowwise_terms data arrays must have grid rank (T, *plane); got {tuple(darr.shape)}"
                )
            glob, local, dwidths = {}, False, [(0, 0)] * ndim
            for dim, axis in plan.dim_axis.items():
                nglob = domain.cshape[dim] + (1 if loc0[dim] == "n" else 0)
                nloc = local_shape[dim]
                s = darr.shape[dim]
                if s == 1 and dim > 0:
                    continue
                if s == nglob:
                    glob[dim] = dim
                elif s == nloc:
                    local = True
                else:
                    raise ValueError(
                        f"halo mode: data array of shape {tuple(darr.shape)}: size {s} along partitioned dimension "
                        f"'{domain.dimnames[dim]}' matches neither the global ({nglob}) nor the local ({nloc}) extent"
                    )
                dwidths[dim] = tuple(w0[dim])
            if not local:
                blocks = {s.key: _local_block(darr, plan, s, loc0, glob) for s in plan.shards}
                return _extend_all(blocks, plan, dwidths, loc0, glob)[shard.key], None
            return None, (_local_block(darr, plan, shard, loc0, glob), dwidths, loc0)

        localized = [_localize_data(d) for d in data]
        ext_data = tuple(e for e, _ in localized)
        local_data = {j: p for j, (_, p) in enumerate(localized) if p is not None}

        lo0 = w0[0][0]
        node0 = loc0[0] == "n"
        ax0 = plan.dim_axis.get(0)
        k0 = plan.axis_sizes[ax0] if ax0 else 1
        n_real = local_shape[0]
        B0 = domain.cshape[0] // k0
        pmask = plan.plane_mask(shard, tuple(exts[0].shape[1:]), [tuple(w0[d]) for d in range(1, ndim)], dtype)
        i0 = shard.index[ax0] if ax0 is not None else 0
        off = i0 * B0 - lo0
        own = i0 == 0
        if ax0 is not None and (lo0 or w0[0][1]):
            r_lo = lo0 + (1 if node0 and k0 > 1 and not own else 0)
            r_hi = lo0 + n_real
        else:
            r_lo, r_hi = 0, exts[0].shape[0]

        def _pad_const(c):
            c = torch.as_tensor(c).to(shard.device)
            if c.ndim == ndim - 1 and tuple(c.shape) == tuple(local_shape[1:]):
                pad = []
                for d in range(ndim - 1, 0, -1):
                    pad += list(w0[d])
                if any(pad):
                    c = torch.nn.functional.pad(c, pad)
            return c

        user_consts = tuple(_pad_const(c) for c in consts)
        T_glob = domain.cshape[0] + (1 if node0 else 0)
        model = halo_model(row_fn, pmask, off, T_glob, r_lo, r_hi)
        count = 1.0
        for d in range(ndim):
            count *= domain.cshape[d] + (1 if loc0[d] == "n" else 0)
        # The masked-edge contract (odil_tpu/halo.py:894-899, xpad_ok) is the
        # plane mask of `model` alone: the kernels take the unpadded extent.
        idx = len(self.rowwise_deferred)
        self.rowwise_deferred.append(
            dict(
                row_fn=model, fields=exts, params=tuple(params), data=ext_data, local_data=local_data,
                consts=user_consts, nterms=nterms, hist=hist, count=count, block_rows=block_rows, stream=stream,
                halox=halox,
            )
        )
        out = []
        for t in range(nterms):
            r = Context.Raw(None)
            r.from_rowwise = True
            r.deferred = (idx, t)
            out.append(r)
        return out

    def neural_net(self, key, frozen=False):
        net = self._params[key]
        if not isinstance(net, NeuralNet):
            raise TypeError(f"Expected NeuralNet, got {type(net).__name__} for '{key}'")
        return lambda *inputs: eval_neural_net(net, inputs, frozen=frozen)

    # -- Localized geometry ---------------------------------------------------

    def _local_1d(self, full, d, loc_d):
        axis = self.plan.dim_axis.get(d)
        if axis is None:
            return full
        k = self.plan.axis_sizes[axis]
        n = len(full)
        B = (n - 1) // k if loc_d == "n" else n // k
        off = self.shard.index[axis] * B
        return full[off : off + B + (1 if loc_d == "n" else 0)]

    def indices(self, *dims, loc=None):
        domain = self.domain
        loc = loc or "c" * domain.ndim
        active_names = [v for v, c in zip(domain.dimnames, loc) if c in "cn"]
        idims = domain._dim_indices(dims, active_names)
        axes_1d = [
            self._local_1d(np.arange(domain.cshape[d] + (1 if loc[d] == "n" else 0)), d, loc[d])
            for d in range(domain.ndim)
            if loc[d] in "cn"
        ]
        grids = torch.meshgrid(*[torch.as_tensor(a, device=self.shard.device) for a in axes_1d], indexing="ij")
        res = tuple(grids[i] for i in idims)
        return res[0] if len(dims) == 1 else res

    def points(self, *dims, loc=None):
        domain = self.domain
        loc = loc or "c" * domain.ndim
        assert len(loc) == domain.ndim, f"loc={loc} vs ndim={domain.ndim}"
        active_names = [v for v, c in zip(domain.dimnames, loc) if c != "."]
        idims = domain._dim_indices(dims, active_names)
        axes_1d = [
            self._local_1d(domain._points_1d(d, loc[d]), d, loc[d]) for d in range(domain.ndim) if loc[d] != "."
        ]
        grids = torch.meshgrid(*[torch.as_tensor(a, device=self.shard.device) for a in axes_1d], indexing="ij")
        res = tuple(grids[i] for i in idims)
        return res[0] if len(dims) == 1 else res


def _extended(plan, grid):
    """Every grid field's halo-extended blocks, {key: {shard key: block}},
    from the shards' local blocks."""
    keys = list(grid)
    ext = _extend_many(plan, [(grid[k], plan.widths[k], plan.locs[k], None) for k in keys])
    return dict(zip(keys, ext))


def _contexts(problem, plan, ext, params, tracers):
    """One ``_HaloContext`` per local shard, in shard order."""
    return [
        _HaloContext(plan, s, {k: v[s.key] for k, v in ext.items()}, params[s.key], plan.local_extra(problem, s),
                     tracers)
        for s in plan.local_shards
    ]


def _run_operators(problem, plan, ext, params, tracers):
    """Runs the operator on every local shard's context, then extends the recorded
    kernel calls' shard-local data (``_exchange_data``): [(ctx, values)]."""
    results = [(ctx, problem._run_operator(ctx)[1]) for ctx in _contexts(problem, plan, ext, params, tracers)]
    _exchange_data(plan, [ctx for ctx, _ in results])
    return results


def _exchange_data(plan, ctxs):
    """Extends the shard-local per-row data of the recorded kernel calls by
    their halo from the same call's data on the neighbouring shards: the
    ppermute exchange of ``odil_tpu/halo.py``'s ``_localize_data`` for data of
    the local extent (every shard records the same calls in the same order;
    a neighbour in another process sends its data through ``comm``)."""
    for idx, rec in enumerate(ctxs[0].rowwise_deferred):
        for j, (_, widths, loc) in rec["local_data"].items():
            blocks = {c.shard.key: c.rowwise_deferred[idx]["local_data"][j][0] for c in ctxs}
            ext = _extend_all(blocks, plan, widths, loc)
            for c in ctxs:
                r = c.rowwise_deferred[idx]
                r["data"] = r["data"][:j] + (ext[c.shard.key],) + r["data"][j + 1 :]


def _mg_metas(problem, state, plan):
    return {
        k: _mg_ladder_meta(problem.domain, plan, k, f) for k, f in state.fields.items() if isinstance(f, MultigridField)
    }


def make_halo_loss_fn(problem, state, extra_partition=None, mg_ladder="local"):
    """Returns (loss_fn, arrays0) with the contract of ``Problem.make_loss_fn``
    (``loss_fn(arrays, tracers) -> (loss, (terms, norms))``, differentiable by
    autograd), evaluated per shard with the halo exchange
    (``odil_tpu/halo.py:1058``).

    extra_partition: optional {attr_name: tuple of dim names | None}
    overriding the automatic localization of ``ctx.extra`` arrays.

    mg_ladder: ``"local"`` (the default) runs the multigrid Horner ladder
    per shard, each shard prolonging only the coarse window that feeds its
    block; ``"global"`` runs it on the whole grid before the shards (the
    JAX package's GSPMD prologue) and localizes its fine fields like plain
    Fields."""
    if mg_ladder not in ("local", "global"):
        raise ValueError(f"mg_ladder must be 'local' or 'global', got {mg_ladder!r}")
    global_ladder = mg_ladder == "global"
    plan = _HaloPlan(problem, state, extra_partition=extra_partition)
    problem._capture_structure(state)
    arrays0 = problem.domain.arrays_from_state(state)
    if plan.spmd:
        arrays0 = shard_state_arrays(problem.domain, arrays0)
    mg_meta = {} if global_ladder else _mg_metas(problem, state, plan)

    def loss_fn(arrays, tracers):
        plan.chain = comm.Chain()
        grid, params = _localize(problem, plan, mg_meta, plan.inputs(arrays, global_ladder), global_ladder)
        per_shard, counts = [], None
        for ctx, values in _run_operators(problem, plan, _extended(plan, grid), params, tracers):
            kernel_sums = [
                rowwise_loss_sums(r["row_fn"], r["fields"], params=r["params"], data=r["data"], consts=r["consts"],
                                  nterms=r["nterms"], hist=r["hist"], block_rows=r["block_rows"], halox=r["halox"])
                for r in ctx.rowwise_deferred
            ]
            local, cnt = [], []
            for ti, v in enumerate(values):
                if isinstance(v, Context.Raw):
                    if getattr(v, "deferred", None) is None:
                        raise ValueError(
                            "halo mode does not support hand-made Context.Raw terms; "
                            "evaluate fused kernels through ctx.rowwise_terms"
                        )
                    idx, t = v.deferred
                    local.append(kernel_sums[idx][t])
                    cnt.append(ctx.rowwise_deferred[idx]["count"])
                    continue
                mask, count = _plain_term_mask(plan, ctx.shard, v, ti)
                sq = torch.square(v)
                if mask is not None:
                    sq = sq * mask
                local.append(torch.sum(sq))
                cnt.append(count)
            per_shard.append(torch.stack([x.to(plan.first) for x in local]))
            counts = cnt
        terms = [s / c for s, c in zip(_sum_shards(plan, per_shard).unbind(), counts)]
        loss = sum(terms)
        norms = [torch.sqrt(t) for t in terms]
        return loss, (terms, norms)

    return loss_fn, arrays0


def make_halo_residual_fn(problem, state, extra_partition=None):
    """Returns ``(f, x0)`` with the contract of ``Problem.residual_fn``
    (``f(packed) -> the concatenated residual vector``, differentiable by
    ``torch.func.jvp``/``vjp`` and autograd; ``f.term_names`` and
    ``f.term_sizes``), evaluated per shard with the halo exchange
    (``odil_tpu/halo.py:1171``).

    Each shard runs the operator on its halo-extended blocks, every
    grid-rank term masked by its ownership mask (``_plain_term_mask``: the
    duplicated ghost node is zero on every shard but the left one).  The
    shards' grid-rank terms are stitched into the ghost-noded global layout
    as ``shard_map``'s ``out_specs=P(*dim_axis)`` stitches them: the blocks
    concatenated along the partitioned dimensions in mesh order, so the
    vector has the JAX map's length and order element for element.  Other
    terms (scalar penalties, parameter regularizers) come from the first
    shard, as the JAX package's replicated out-spec takes them.  Up to a
    fixed permutation plus structurally zero rows, f is
    ``Problem.residual_fn``'s map: the normal equations are the same.

    Over several processes the packed state x is whole and the same on every
    process, and f(x) is this process's part of the vector: its shards'
    blocks stitched over its box of the mesh (the other terms on the
    process of the first shard only).  Each process slices the blocks of
    every shard from x (``_localize(..., every=True)``), so f exchanges
    nothing and ``torch.func`` differentiates it as it is; what crosses
    processes is left to the caller (``newton.py``) through the attributes
    that f then carries: ``reduce_x`` (the ordered sum of the processes'
    x-space vectors, ``comm.allsum``: J^T w is the sum of the processes'
    pullbacks), ``term_sums(r)`` (each term's sum of squares over the whole
    vector, folded in shard order through ``comm.psum_table``),
    ``term_counts`` (the terms' whole sizes) and ``local_part(z)`` (this
    process's part of a vector of the whole map's layout, e.g. a probe drawn
    whole on every process).

    The localization runs eagerly (no CUDA graphs), so that forward-mode
    products pass through it.  Kernel operators (``ctx.rowwise_terms``) are
    declined, as in the JAX package: their halo form reduces straight to
    masked sums."""
    plan = _HaloPlan(problem, state, extra_partition=extra_partition)
    if plan.rowwise_calls:
        raise ValueError(
            "make_halo_residual_fn: kernel operators (ctx.rowwise_terms) "
            "have no per-row residual form under halo; build the problem "
            "with the plain operator (kernel='xla')"
        )
    domain = problem.domain
    problem._capture_structure(state)
    arrays0 = domain.arrays_from_state(state)
    shapes = [tuple(a.shape) for a in arrays0]
    sizes = [int(np.prod(s)) for s in shapes]
    mg_meta = _mg_metas(problem, state, plan)
    # The grid dimension of each partitioning axis, in mesh order: the order
    # in which the shard keys index the blocks.
    axis_dim = {a: d for d, a in plan.dim_axis.items()}
    stitch_dims = [axis_dim[a] for a in plan.used_axes]
    first_here = plan.shards[0].owner == plan.mesh.process
    other_shapes = {}  # the shapes of the terms that are not grid-rank

    def stitch(blocks):
        """One tensor from {shard key: block}: the blocks concatenated along
        each partitioned dimension, the last mesh axis innermost."""
        for pos in range(len(stitch_dims) - 1, -1, -1):
            groups = {}
            for key in sorted(blocks):
                groups.setdefault(key[:pos], []).append(blocks[key])
            blocks = {k: torch.cat(v, dim=stitch_dims[pos]) for k, v in groups.items()}
        return blocks[()]

    def f_values(x):
        arrays = [p.reshape(s) for p, s in zip(torch.split(x, sizes), shapes)]
        grid, params = _localize(problem, plan, mg_meta, arrays, every=plan.spmd)
        results = _run_operators(problem, plan, _extended(plan, grid), params, problem.tracers)
        out = []
        for ti in range(len(results[0][1])):
            blocks = {}
            for ctx, values in results:
                v = values[ti]
                mask, _ = _plain_term_mask(plan, ctx.shard, v, ti)
                blocks[ctx.shard.key] = (v if mask is None else v * mask).to(plan.first)
            some = blocks[plan.local_shards[0].key]
            if some.ndim == domain.ndim:
                out.append(stitch(blocks))
            else:
                other_shapes[ti] = tuple(some.shape)
                out.append(blocks[plan.shards[0].key] if first_here else some.reshape(-1)[:0])
        return out

    def f(x):
        return torch.cat([v.reshape(-1) for v in f_values(x)])

    x0 = torch.cat([a.detach().reshape(-1) for a in arrays0])
    with torch.no_grad():
        values = f_values(x0)
    f.term_names = list(plan.names)
    f.term_sizes = [int(v.numel()) for v in values]
    if plan.spmd:
        _spread_residual_space(f, plan, values, other_shapes, stitch_dims)
    return f, x0


def _spread_residual_space(f, plan, values, other_shapes, stitch_dims):
    """The attributes of a residual map over processes
    (``make_halo_residual_fn``): ``reduce_x``, ``term_sums``,
    ``term_counts`` and ``local_part``.  ``values``: this process's terms at
    x0 (their shapes give the layout); ``other_shapes``: {term: shape} of
    the terms that are not grid-rank."""
    ndim = plan.domain.ndim
    box = plan.mesh.box()
    first_here = plan.shards[0].owner == plan.mesh.process
    grid_term = []  # per term: None, or the block extent along each stitch dimension and the whole shape
    counts = []
    for v in values:
        if v.ndim != ndim:
            grid_term.append(None)
            counts.append(int(np.prod(other_shapes[len(counts)])))
            continue
        extent = [v.shape[d] // box[a][1] for a, d in zip(plan.used_axes, stitch_dims)]
        whole = list(v.shape)
        for a, d, e in zip(plan.used_axes, stitch_dims, extent):
            whole[d] = e * plan.axis_sizes[a]
        grid_term.append((extent, tuple(whole)))
        counts.append(int(np.prod(whole)))
    sizes = list(f.term_sizes)

    def blocks_of(t, ti):
        """This process's shards' blocks of term ``ti``'s stitched tensor
        ``t``, in shard order."""
        extent, _ = grid_term[ti]
        out = []
        for s in plan.local_shards:
            b = t
            for a, d, e in zip(plan.used_axes, stitch_dims, extent):
                b = b.narrow(d, (s.index[a] - box[a][0]) * e, e)
            out.append(b)
        return out

    def term_sums(r):
        rows = [[] for _ in plan.local_shards]
        for ti, (p, size) in enumerate(zip(torch.split(r, sizes), sizes)):
            if grid_term[ti] is None:
                for n, s in enumerate(plan.local_shards):
                    rows[n].append(torch.sum(torch.square(p)) if s.number == 0 else torch.zeros((), dtype=r.dtype,
                                                                                                device=r.device))
                continue
            shape = list(values[ti].shape)
            for n, b in enumerate(blocks_of(p.reshape(shape), ti)):
                rows[n].append(torch.sum(torch.square(b)))
        table = comm.psum_table(torch.stack([torch.stack(row) for row in rows]), plan.process_shards,
                                len(plan.shards))
        acc = table[0]
        for row in table[1:]:
            acc = acc + row
        return acc

    def local_part(z):
        out = []
        for ti, p in enumerate(torch.split(z, counts)):
            if grid_term[ti] is None:
                out.append(p if first_here else p[:0])
                continue
            extent, whole = grid_term[ti]
            b = p.reshape(whole)
            for a, d, e in zip(plan.used_axes, stitch_dims, extent):
                b = b.narrow(d, box[a][0] * e, box[a][1] * e)
            out.append(b.reshape(-1))
        return torch.cat(out)

    f.reduce_x = lambda v: comm.allsum(v, group=plan.replica_group)
    f.term_sums = term_sums
    f.term_counts = counts
    f.local_part = local_part


def make_halo_loss_grad_fn(problem, state, extra_partition=None, fuse=None):
    """One-pass fused loss+gradients per shard: the ``--halo`` form of
    ``Problem.make_loss_grad_fn`` (``odil_tpu/halo.py:1296``; the same
    contract, ``fn(arrays, tracers) -> ((loss, (terms, norms)), grads)``).

    Two routes: the GENERIC one-pass for any operator whose kernels run
    through ``ctx.rowwise_terms`` (``_make_halo_onepass_loss_grad_fn``) and
    the MG-fused per-shard kernel (``_make_halo_mg_loss_grad_fn``, for
    operators exposing a ``kernel_decl``).  ``fuse`` picks the route tried
    first: ``"generic"`` (the default; env ``ODIL_HALO_FUSE`` overrides) or
    ``"mg"``; the other is the fallback.  The returned function carries the
    route's name as ``fn.route``.  None when neither applies; callers then
    differentiate ``make_halo_loss_fn`` with autograd."""
    if fuse is None:
        fuse = os.environ.get("ODIL_HALO_FUSE", "generic")
    if fuse not in ("generic", "mg"):
        raise ValueError(f"halo fuse must be 'generic' or 'mg', got {fuse!r}")
    builders = [("generic", _make_halo_onepass_loss_grad_fn), ("mg", _make_halo_mg_loss_grad_fn)]
    if fuse == "mg":
        builders.reverse()
    for name, builder in builders:
        fn = builder(problem, state, extra_partition=extra_partition)
        if fn is not None:
            fn.route = name
            return fn
    return None


def _wide_on_card(domain):
    """64-bit fields on the card: the kernels take float32 (the JAX
    package's Mosaic rule on the TPU); on the CPU the plain versions run in
    any dtype, as the JAX package's interpreter does."""
    return domain.device.type == "cuda" and np.dtype(domain.dtype).itemsize > 4


def _graphed(store, fn, arrays, live):
    """The localization ``fn`` and its vjp as CUDA graphs (captured at the
    first call; ``problem._GraphedPrologue``)."""
    from .problem import _GraphedPrologue

    if not store:
        store.append(_GraphedPrologue(fn, arrays, live))
    return store[0]


def _make_halo_mg_loss_grad_fn(problem, state, extra_partition=None):
    """The MG-fused halo one-pass (``odil_tpu/halo.py:1343``): per shard ONE
    local-block kernel (``rowwise_mg_local_loss_and_grads``) rebuilds the
    fine rows from the shard's x-extended level-0 block and its time window
    of the level-1 partial, with the ``hist`` fine rows before the block as
    heads, and emits the loss sums and the cotangents together.

    - prologue: the batched multigrid flatten stopped at the level-1 partial;
    - localization: the shard's ghost-noded level-0 block, extended by the x
      halo from its neighbours; the partial's window rows g0/2 ..
      g0/2 + Tcw - 1; the heads, rebuilt from the global level-0 term and
      partial at global rows g0-hist .. g0-1 (periodic) with the kernel's
      operation order (the JAX package rebuilds them on the ring predecessor
      and ppermutes them: the same values).  Across processes the coarse
      levels are gathered whole, so the partial is whole on every process;
      the level-0 term is this process's block, whole along t, so the heads'
      rows are its own and only their x halo comes from the neighbours;
    - per-shard sums and the window cotangents are summed over the shards
      by autograd of the localization.

    Returns None where the JAX package's builder does: no
    ``operator.kernel_decl``, multigrid off, 2D/4D grids, odd T, a lane (y)
    partition, parameter unknowns, not one kernel call, hist < 1, depth-2
    partials or extra grouped fields, non-"ncc" fields, per-row data, odd
    local t blocks, blocks too short for the ring or the x halo; and for
    64-bit fields on the card."""
    domain = problem.domain
    op = problem.operator
    decl_fn = getattr(op, "kernel_decl", None)
    if decl_fn is None or getattr(op, "loss_and_grads", None) is None:
        return None
    if not getattr(problem, "mg_partial", False):
        return None
    if _wide_on_card(domain):
        return None
    if domain.ndim != 3 or domain.cshape[0] % 2:
        return None
    problem._capture_structure(state)
    arrays0 = domain.arrays_from_state(state)
    probe = {}
    with torch.no_grad():
        problem._flatten_multigrid_batched(problem.state_from_arrays(arrays0), partial_out=probe)
    if not probe:
        return None
    plan = _HaloPlan(problem, state, extra_partition=extra_partition)
    if plan.param_keys or len(plan.rowwise_calls) != 1:
        return None
    if plan.dim_axis.get(domain.ndim - 1) is not None:
        # Lane-axis (last-dim) partitions take the generic route.
        return None
    call = plan.rowwise_calls[0]
    keys = tuple(call["keys"])
    hist, halox, nterms = call["hist"], call["halox"], call["nterms"]
    if hist < 1:
        return None
    if set(keys) != set(probe) or any(len(probe[k]) != 3 for k in keys):
        return None  # Depth-2 partials / extra grouped fields: unsupported.
    if any(plan.locs[k] != "ncc" for k in keys):
        return None
    decl0 = decl_fn(Context(domain, state, extra=problem.extra, tracers=problem.tracers))
    if decl0.get("data"):
        return None
    ax_t = plan.dim_axis.get(0)
    ax_x = plan.dim_axis.get(1)
    k_t = plan.axis_sizes[ax_t] if ax_t else 1
    k_x = plan.axis_sizes[ax_x] if ax_x else 1
    Tcells, X, Y = domain.cshape
    B = Tcells // k_t
    if k_t > 1 and B % 2:
        return None
    XB = X // k_x
    Tl = B + 1
    if Tl <= 2 * hist or (k_x > 1 and XB <= 2 * halox):
        return None
    T_glob = Tcells + 1
    cells = float(T_glob) * X * Y
    hx = halox if k_x > 1 else 0
    Xe = XB + 2 * hx
    if any(tuple(probe[k][0].shape) != (T_glob, X, Y) for k in keys):
        return None
    CX, CY = probe[keys[0]][2].shape[1:]
    if (CX, CY) != (X // 2, Y // 2):
        return None
    f0s = tuple(float(probe[k][1]) for k in keys)
    Tcw = B // 2 + 1
    x_widths = [(0, 0), (hx, hx), (0, 0)]
    # Per shard: the first global row g0 and column x0 of the block, the
    # block's global columns and the heads' global rows (index tensors made
    # here, outside the CUDA graph), and whether it owns its first row.
    geo = {}
    for s in plan.local_shards:
        i_t = s.index[ax_t] if ax_t else 0
        x0 = (s.index[ax_x] * XB if ax_x else 0) - hx
        xcols = ((x0 + torch.arange(Xe)) % X).to(domain.device)
        hrows = (torch.arange(i_t * B - hist, i_t * B) % T_glob).to(domain.device)
        geo[s.key] = (i_t * B, x0, xcols, hrows, i_t == 0)

    def localize(*arrs):
        """(t0x, Pw, heads) of every local shard, flat: shard-major,
        field-minor."""
        partials = {}
        problem._flatten_multigrid_batched(problem.state_from_arrays(plan.inputs(arrs)), partial_out=partials)
        out = []
        items = []
        for k in keys:
            t0, start = partials[k][0], plan.starts.get(k)
            items.append(({s.key: _local_block(t0, plan, s, "ncc", start=start) for s in plan.local_shards},
                          x_widths, "ncc", None))
        if plan.spmd:
            # The heads' rows at the shard's columns, x-extended like the
            # blocks: t0[hrows][:, xcols] without the global t0.
            for k in keys:
                t0, start = partials[k][0], plan.starts.get(k)
                items.append(({s.key: _local_block(t0[geo[s.key][3]], plan, s, "ncc", dims={1: 1}, start=start)
                               for s in plan.local_shards}, x_widths, "ncc", {1: 1}))
        ext = _extend_many(plan, items) if hx else [blocks for blocks, *_ in items]
        t0x, t0h = dict(zip(keys, ext)), dict(zip(keys, ext[len(keys):]))
        for s in plan.local_shards:
            g0, _, xcols, hrows, _ = geo[s.key]
            for j, k in enumerate(keys):
                t0, P = partials[k][0], partials[k][2]
                Pw = P.narrow(0, g0 // 2, Tcw) if k_t > 1 else P
                heads = _head_rows(t0, P, hrows, xcols, f0s[j], t0h[k][s.key] if plan.spmd else None)
                out += [t0x[k][s.key], Pw.to(s.device), heads.to(s.device)]
        return tuple(out)

    graphs = []

    def loss_grad_fn(arrays, tracers):
        plan.chain = comm.Chain()
        if arrays[0].is_cuda and not plan.spmd:
            g = _graphed(graphs, localize, arrays, list(range(len(arrays))))
            parts = g.forward(arrays)
        else:
            leaves = [a.detach().requires_grad_(True) for a in arrays]
            with torch.enable_grad():
                parts = localize(*leaves)
        per_shard = []
        douts = []
        for n, s in enumerate(plan.local_shards):
            g0, x0, _, _, own = geo[s.key]
            local_extra = plan.local_extra(problem, s)
            dctx = _HaloContext(plan, s, None, {}, local_extra, tracers)
            decl = decl_fn(dctx)
            assert tuple(decl["keys"]) == keys and decl["nterms"] == nterms
            consts = []
            for c in decl.get("consts", ()):
                c = torch.as_tensor(c).to(s.device)
                if c.ndim == 2 and tuple(c.shape) == (XB, Y) and hx:
                    c = torch.nn.functional.pad(c, (0, 0, hx, hx))
                consts.append(c)
            base = parts[n * 3 * len(keys) : (n + 1) * 3 * len(keys)]
            t0s = tuple(p.detach() for p in base[0::3])
            Pws = tuple(p.detach() for p in base[1::3])
            heads = tuple(p.detach() for p in base[2::3])
            pmask = plan.plane_mask(s, (Xe, Y), [(hx, hx), (0, 0)], t0s[0].dtype)
            r_lo = 0 if (k_t == 1 or own) else 1
            model = halo_model(decl["row_fn"], pmask, g0, T_glob, r_lo, Tl)
            lsums, (dt0, dPw, dheads, _) = rowwise_mg_local_loss_and_grads(
                model, t0s, Pws, f0s, heads, x0=x0, consts=consts, nterms=nterms, hist=hist, gscale=1.0 / cells
            )
            per_shard.append(lsums.to(plan.first))
            for j in range(len(keys)):
                douts += [dt0[j], dPw[j], dheads[j]]
        sums = _sum_shards(plan, per_shard)
        if arrays[0].is_cuda and not plan.spmd:
            grads = g.backward(douts)
        else:
            grads = list(torch.autograd.grad(parts, leaves, douts, allow_unused=True))
        grads = [torch.zeros_like(a) if d is None else d for a, d in zip(arrays, grads)]
        tv = sums / cells
        return (tv.sum(), (list(tv.unbind()), list(torch.sqrt(tv).unbind()))), grads

    return loss_grad_fn


def _head_rows(t0, P, r, xcols, f0, t0r=None):
    """Fine rows ``r`` (global row indices) at the global columns ``xcols``,
    rebuilt from the level-0 term and the level-1 partial in the operation
    order of ``ops/rowwise_mg._recon_rows``; ``t0r``, where given, is
    ``t0[r][:, xcols]`` already gathered."""
    Tc, CX, CY = P.shape
    Wx, Wy = _interp_matrices(CX, CY, P.dtype, P.device)
    w = (0.5 * (r % 2).to(P.dtype)).view(-1, 1, 1)
    c = (1.0 - w) * P[r // 2] + w * P[torch.clamp(r // 2 + 1, max=Tc - 1)]
    return f0 * (t0[r][:, xcols] if t0r is None else t0r) + torch.matmul(Wx[xcols], torch.matmul(c, Wy.T))


def _make_halo_onepass_loss_grad_fn(problem, state, extra_partition=None):
    """The GENERIC halo one-pass (``odil_tpu/halo.py:1667``): the per-shard
    mirror of ``Problem._make_onepass_loss_grad_fn`` for any operator whose
    kernel terms come through ``ctx.rowwise_terms``.

    Per step: the localization (local multigrid ladders, parameter copies,
    halo exchange) runs once under autograd -- on the card as two CUDA
    graphs over the extended blocks -- and the operator runs per shard in
    deferred mode.  Each recorded call then runs the backward kernel with
    the sums on (``rowwise_loss_and_grads``: masked per-term sums and
    cotangents in one sweep), non-kernel terms get their masked mean-square
    cotangents, and one ``torch.autograd.grad`` folds every cotangent back
    onto the arrays -- the halo exchange's transpose included.  Per-term sums
    are summed over the shards against the global counts.

    Returns None when no kernel call is recorded, a call streams, or (in
    one process) the deferred probe fails; and for 64-bit fields on the
    card.  Across processes the route is decided from the plan alone, which
    every process builds from the same state, before any collective: the
    probe then runs on every process and a failure raises."""
    domain = problem.domain
    if _wide_on_card(domain):
        return None
    plan = _HaloPlan(problem, state, extra_partition=extra_partition)
    if not plan.rowwise_calls or plan.streams:
        return None
    problem._capture_structure(state)
    arrays0 = domain.arrays_from_state(state)
    if plan.spmd:
        arrays0 = shard_state_arrays(domain, arrays0)
    mg_meta = _mg_metas(problem, state, plan)
    grid_keys = list(plan.locs)
    fields = problem._template.fields
    spans, pos = {}, 0
    for k, f in fields.items():
        spans[k] = list(range(pos, pos + len(field_arrays(f))))
        pos += len(spans[k])
    direct = [i for k in plan.param_keys for i in spans[k]]  # parameter unknowns: leaves as they are
    live = [i for i in range(pos) if i not in direct]

    def deferred_calls():
        with torch.no_grad():
            grid0, params0 = _localize(problem, plan, mg_meta, plan.inputs(arrays0))
            probe = []
            for ctx, _ in _run_operators(problem, plan, _extended(plan, grid0), params0, problem.tracers):
                probe += ctx.rowwise_deferred
        return probe

    if plan.spmd:
        deferred_calls()
    else:
        try:
            probe = deferred_calls()
        except (ValueError, NotImplementedError, RuntimeError, TypeError, KeyError):
            return None
        if not probe or any(r["stream"] for r in probe):
            return None

    def localize(*arrs):
        """Every local shard's extended block of every grid field, flat
        (key-major, shard-minor)."""
        ext = _extended(plan, _localize(problem, plan, mg_meta, plan.inputs(arrs, kinds=("block", "whole")))[0])
        return tuple(ext[k][s.key] for k in grid_keys for s in plan.local_shards)

    graphs = []

    def loss_grad_fn(arrays, tracers):
        plan.chain = comm.Chain()
        n = len(plan.local_shards)
        if arrays[0].is_cuda and not plan.spmd:
            g = _graphed(graphs, localize, arrays, live)
            exts = [e.requires_grad_(True) for e in g.forward(arrays)]
            own = {i: arrays[i].detach().requires_grad_(True) for i in direct}
            leaves = exts + [own[i] for i in direct]
            st = problem.state_from_arrays([own.get(i, a) for i, a in enumerate(arrays)])
        else:
            leaves = [a.detach().requires_grad_(True) for a in arrays]
            with torch.enable_grad():
                exts = list(localize(*leaves))
                st = problem.state_from_arrays(plan.inputs(leaves, kinds=("param",)))
        ext = {k: {s.key: exts[j * n + m] for m, s in enumerate(plan.local_shards)} for j, k in enumerate(grid_keys)}
        params = {s.key: {k: _param_on(st.fields[k], s.device) for k in plan.param_keys} for s in plan.local_shards}
        with torch.enable_grad():
            results = _run_operators(problem, plan, ext, params, tracers)

        # Per shard a row of the terms' sums: a kernel term's raw sum, a plain
        # term's sum over its count; summed over the shards, then the kernel
        # terms over their counts.
        outs, couts = [], []
        kcounts, rows = {}, []
        for ctx, values in results:
            ksums = {}
            for idx, r in enumerate(ctx.rowwise_deferred):
                count = r["count"]
                sums, dfields, dprm = _loss_and_grads(
                    r["row_fn"], [x.detach() for x in r["fields"]], params=[x.detach() for x in r["params"]],
                    data=[x.detach() for x in r["data"]], consts=[x.detach() for x in r["consts"]],
                    nterms=r["nterms"], hist=r["hist"], gscale=1.0 / count,
                )
                ksums[idx] = sums.to(plan.first)
                for t in range(r["nterms"]):
                    kcounts[(idx, t)] = count
                for x, d in zip(tuple(r["fields"]) + tuple(r["params"]), tuple(dfields) + tuple(dprm)):
                    if x.requires_grad:
                        outs.append(x)
                        couts.append(d)
            row = []
            for ti, v in enumerate(values):
                if isinstance(v, Context.Raw):
                    idx, t = v.deferred
                    row.append(ksums[idx][t])
                    continue
                mask, count = _plain_term_mask(plan, ctx.shard, v, ti)
                sq = torch.square(v.detach())
                d = (2.0 / count) * v.detach()
                if mask is not None:
                    sq = sq * mask
                    d = d * mask
                row.append(torch.sum(sq).to(plan.first) / count)
                if v.requires_grad:
                    outs.append(v)
                    couts.append(d)
            rows.append(torch.stack(row))
        dleaves = torch.autograd.grad(outs, leaves, couts, allow_unused=True) if outs else [None] * len(leaves)
        dleaves = [torch.zeros_like(a) if d is None else d for a, d in zip(leaves, dleaves)]
        if arrays[0].is_cuda and not plan.spmd:
            grads = g.backward(dleaves[: len(exts)])
            for i, d in zip(direct, dleaves[len(exts) :]):
                grads[i] = d
        else:
            grads = dleaves
        grads = [torch.zeros_like(a) if d is None else d for a, d in zip(arrays, grads)]
        sums = _sum_shards(plan, rows).unbind()
        terms = []
        for ti, v in enumerate(results[0][1]):
            terms.append(sums[ti] / kcounts[v.deferred] if isinstance(v, Context.Raw) else sums[ti])
        tv = torch.stack([torch.as_tensor(t, dtype=arrays[0].dtype, device=plan.first) for t in terms])
        return (tv.sum(), (list(tv.unbind()), list(torch.sqrt(torch.clamp(tv, min=0)).unbind()))), grads

    return loss_grad_fn
