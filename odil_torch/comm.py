"""The collectives of the per-shard (halo) route across processes.

PyTorch counterpart of the collectives that ``shard_map`` gives the JAX
package's halo route (``odil_tpu/halo.py``): ``ppermute`` for the halo
exchange, ``psum`` for the loss sums, and the sum that GSPMD's transpose
makes of the cotangents of an array that several devices read.  Each is an
autograd Function over ``torch.distributed``'s default group:

- ``ppermute(sends, recvs)``: slabs to and from other processes by
  send/recv (``batch_isend_irecv``); its backward sends the received slabs'
  cotangents back and receives those of the sent ones;
- ``psum_table(values, index, count)``: every process's per-shard values
  gathered into one table in shard order, the same bits on every process
  (the caller folds the rows in that order; a shard that several processes
  evaluate, replicas along an idle mesh axis, enters once, from the lowest
  rank); its backward takes the rows of the process's own shards, since
  every process evaluates the same loss;
- ``replicas(xs, group)``: the identity forward; backward, the cotangents
  of the processes that hold the same blocks, summed in rank order;
- ``gather(xs, specs)``: the whole arrays from every process's blocks;
  backward, each process's block of every process's cotangent (or of those
  of a ``group``, one replica), summed in rank order;
- ``gather_replicated(xs, specs)``: the same whole arrays, for an
  evaluation that every process runs whole (the GSPMD route over
  processes); backward, this process's block of its own cotangent, since
  every process differentiates the same function of them;
- ``allsum(x)``: the sum of every process's ``x`` (or of a ``group``'s;
  whole x-space vectors of Gauss-Newton), added in rank order, so every
  process gets the same bits; backward, the identity, as for
  ``psum_table``; under ``torch.func.vmap`` one exchange for the whole
  batch.

Each call is one round of messages, one a peer: its pieces are packed.

Every process issues the same collectives in the same order.  In the
forward that is the program's order.  In the backward each Function that
communicates there takes the previous one's token as an input and gives a
new token as an output (a ``Chain``, one an evaluation), so its backward
runs only after the next one's: the reverse order on every process,
whatever order autograd would otherwise pick among ready nodes.

The transport is the backend's: under NCCL card tensors are sent as they
are; under gloo, whose send/recv take host tensors, a card tensor is copied
into a pinned host buffer and back (``transport``).  A failed collective
raises ``CollectiveError``, which no caller catches: a process that went on
alone would hang the others.
"""

import torch
import torch.distributed as dist

__all__ = [
    "Chain", "CollectiveError", "allsum", "gather", "gather_replicated", "initialized", "ppermute", "psum_table",
    "rank", "replicas", "transport", "world_size",
]


class CollectiveError(Exception):
    """A collective failed (a peer died, the group timed out).  Not a
    RuntimeError, so that no handler of the operators' own errors takes it."""


def initialized():
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if initialized() else 0


def world_size():
    return dist.get_world_size() if initialized() else 1


def _staged(device):
    """Whether tensors of ``device`` pass through host memory: gloo's
    send/recv and all_gather take host tensors."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def transport():
    """How this process's card tensors travel, for the logs."""
    if not initialized():
        return "none (one process)"
    backend = dist.get_backend()
    if backend == "gloo":
        return "gloo: card tensors staged through pinned host buffers"
    return f"{backend}: card tensors sent as they are"


def _wire(t):
    """``t`` as the backend sends it: contiguous, and a pinned host copy
    under gloo for a card tensor."""
    t = t.detach().contiguous()
    if _staged(t.device):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t


def _empty(shape, dtype, device):
    if _staged(device):
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64, torch.int32)


def _exchange(sends, recvs):
    """Point-to-point messages in one round: ``sends`` [(peer, tag,
    tensor)], ``recvs`` [(peer, tag, shape, dtype, device)], tags unique for
    each pair of processes and direction; returns the received tensors in
    the order of ``recvs``, on their devices.  The pieces for one peer (of
    one dtype) travel as one message, packed in tag order on both sides,
    so one round is one send and one receive a peer."""
    out, into = {}, {}
    for peer, tag, t in sorted(sends, key=lambda s: (s[0], s[1])):
        out.setdefault((peer, t.dtype), []).append(t)
    for n in sorted(range(len(recvs)), key=lambda n: (recvs[n][0], recvs[n][1])):
        into.setdefault((recvs[n][0], recvs[n][3]), []).append(n)
    ops, bufs = [], {}
    for (peer, dtype), ts in sorted(out.items(), key=lambda kv: (kv[0][0], _DTYPES.index(kv[0][1]))):
        flat = ts[0].reshape(-1) if len(ts) == 1 else torch.cat([t.reshape(-1) for t in ts])
        ops.append(dist.P2POp(dist.isend, _wire(flat), peer, tag=_DTYPES.index(dtype)))
    for (peer, dtype), ns in sorted(into.items(), key=lambda kv: (kv[0][0], _DTYPES.index(kv[0][1]))):
        numel = sum(int(torch.Size(recvs[n][2]).numel()) for n in ns)
        bufs[(peer, dtype)] = _empty((numel,), dtype, recvs[ns[0]][4])
        ops.append(dist.P2POp(dist.irecv, bufs[(peer, dtype)], peer, tag=_DTYPES.index(dtype)))
    if ops:
        try:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        except Exception as e:  # noqa: BLE001 -- re-raised as the one error no caller takes
            raise CollectiveError(f"send/recv with processes {sorted({o.peer for o in ops})} failed: {e}") from e
    got = [None] * len(recvs)
    for key, ns in into.items():
        flat, pos = bufs[key].to(recvs[ns[0]][4], non_blocking=True), 0
        for n in ns:
            shape, device = recvs[n][2], recvs[n][4]
            size = int(torch.Size(shape).numel())
            got[n] = flat[pos: pos + size].view(shape).to(device)
            pos += size
    return got


# -- Ordering of the backward's collectives --------------------------------

class Chain:
    """The token chain of one evaluation (see the module's text): the token
    of the last Function recorded, None before the first."""

    def __init__(self):
        self.token = None


def _apply(fn, spec, xs, chain):
    """``fn`` (a Function taking ``(spec, token, *xs)``) in ``chain`` when
    autograd records it, else its forward alone."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        out = fn.apply(spec, chain.token, *xs)
        chain.token = out[0]
        return list(out[1:])
    with torch.no_grad():
        return list(fn.apply(spec, None, *xs)[1:])


def _token_grad(ctx):
    return torch.zeros(()) if ctx.chained else None


# -- ppermute -------------------------------------------------------------


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, token, *sends):
        dests, recvs = spec
        ctx.spec = spec
        ctx.chained = token is not None
        ctx.send_meta = [(t.shape, t.dtype, t.device) for t in sends]
        out = _exchange([(p, tag, t) for (p, tag), t in zip(dests, sends)], recvs)
        return (torch.zeros(()),) + tuple(out)

    @staticmethod
    def backward(ctx, _gtoken, *grecv):
        dests, recvs = ctx.spec
        back = [(peer, tag, g) for (peer, tag, *_), g in zip(recvs, grecv)]
        want = [(peer, tag, shape, dtype, device) for (peer, tag), (shape, dtype, device) in zip(dests, ctx.send_meta)]
        gsend = _exchange(back, want)
        return (None, _token_grad(ctx)) + tuple(gsend)


def ppermute(sends, recvs, chain):
    """Slabs to and from other processes: ``sends`` [(peer, tag, tensor)],
    ``recvs`` [(peer, tag, shape, dtype, device)] (the sender's tag); returns
    the received slabs in the order of ``recvs``.  Differentiable in the
    sent slabs: the backward is the reverse exchange."""
    spec = ([(p, tag) for p, tag, _ in sends], list(recvs))
    return _apply(_PPermute, spec, [t for _, _, t in sends], chain)


# -- psum ------------------------------------------------------------------


class _PsumTable(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, token, values):
        index, count = spec
        ctx.index = index
        ctx.chained = token is not None
        wire = _wire(values)
        parts = [torch.empty_like(wire) for _ in range(world_size())]
        try:
            dist.all_gather(parts, wire)
        except Exception as e:  # noqa: BLE001 -- re-raised as the one error no caller takes
            raise CollectiveError(f"all_gather of the per-shard sums failed: {e}") from e
        table = [None] * count
        for r, part in enumerate(parts):
            for n, g in enumerate(index[r]):
                if table[g] is None:
                    table[g] = part[n]
        return torch.zeros(()), torch.stack(table).to(values.device)

    @staticmethod
    def backward(ctx, _gtoken, gtable):
        return None, _token_grad(ctx), gtable[list(ctx.index[rank()])]


def psum_table(values, index, count):
    """``values`` (one row per shard of this process) gathered from every
    process into a (count, ...) table in shard order; ``index[r]``: the
    shard numbers of process r's rows (a shard in several processes' lists
    takes the row of the first of them).  Every process gets the same table,
    and with it the same sums when it folds the rows in order.  The backward
    is local: it assumes, as the halo route's losses guarantee, that every
    process differentiates the same function of the table."""
    if torch.is_grad_enabled() and values.requires_grad:
        return _PsumTable.apply((index, count), None, values)[1]
    with torch.no_grad():
        return _PsumTable.apply((index, count), None, values)[1]


# -- Replicated arrays -----------------------------------------------------


def _fold(parts, order):
    """``parts[order[0]] + parts[order[1]] + ...``, in that order."""
    acc = parts[order[0]]
    for r in order[1:]:
        acc = acc + parts[r]
    return acc


class _Replicas(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, token, *xs):
        ctx.group = group
        ctx.chained = token is not None
        return (torch.zeros(()),) + tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, _gtoken, *gs):
        group, me = ctx.group, rank()
        others = [r for r in group if r != me]
        mine = [g.contiguous() for g in gs]
        got = iter(_exchange([(r, i, g) for r in others for i, g in enumerate(mine)],
                             [(r, i, g.shape, g.dtype, g.device) for r in others for i, g in enumerate(mine)]))
        parts = {r: [next(got) for _ in gs] for r in others}
        parts[me] = mine
        sums = [_fold({r: parts[r][i] for r in group}, group) for i in range(len(gs))]
        return (None, _token_grad(ctx)) + tuple(sums)


def replicas(xs, group, chain):
    """The tensors ``xs``, whose cotangents are summed, in rank order, over
    the processes of ``group`` (sorted ranks that hold the same blocks, this
    one included): the same bits on each.  One exchange for all of them."""
    if len(group) == 1 or not xs:
        return list(xs)
    return _apply(_Replicas, tuple(group), list(xs), chain)


# -- Whole arrays from blocks -----------------------------------------------


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, token, *xs):
        me = rank()
        ctx.spec = spec
        spec = spec[0]
        ctx.chained = token is not None
        ctx.blocks = [x.shape for x in xs]
        # One holder (the lowest rank) a distinct block sends it to the
        # processes that hold another block; message tag: the array's index.
        sends, recvs, place = [], [], []
        for i, (x, (regions, _)) in enumerate(zip(xs, spec)):
            holder = {}
            for r, reg in enumerate(regions):
                holder.setdefault(reg, r)
            mine = regions[me]
            sends += [(r, i, x) for r in range(len(regions)) if holder[mine] == me and regions[r] != mine]
            for reg, h in holder.items():
                if reg != mine:
                    recvs.append((h, i, _region_shape(reg), x.dtype, x.device))
                    place.append((i, reg))
        got = _exchange(sends, recvs)
        wholes = []
        for x, (regions, shape) in zip(xs, spec):
            whole = torch.empty(shape, dtype=x.dtype, device=x.device)
            whole[_slices(regions[me])] = x
            wholes.append(whole)
        for (i, reg), t in zip(place, got):
            wholes[i][_slices(reg)] = t
        return (torch.zeros(()),) + tuple(wholes)

    @staticmethod
    def backward(ctx, _gtoken, *gs):
        me = rank()
        specs, group = ctx.spec
        others = [r for r in group if r != me]
        gs = [g.contiguous() for g in gs]
        sends = [(r, i, g[_slices(regions[r])]) for r in others for i, (g, (regions, _)) in enumerate(zip(gs, specs))]
        recvs = [(r, i, ctx.blocks[i], g.dtype, g.device) for r in others for i, g in enumerate(gs)]
        got = iter(_exchange(sends, recvs))
        parts = {r: [next(got) for _ in gs] for r in others}
        parts[me] = [g[_slices(regions[me])] for g, (regions, _) in zip(gs, specs)]
        sums = [_fold({r: parts[r][i] for r in group}, list(group)) for i in range(len(gs))]
        return (None, _token_grad(ctx)) + tuple(sums)


def _slices(region):
    return tuple(slice(lo, hi) for lo, hi in region)


def _region_shape(region):
    return tuple(hi - lo for lo, hi in region)


def _gather_spec(specs, group):
    world = len(specs[0][0])
    return tuple((tuple(r), tuple(s)) for r, s in specs), tuple(range(world) if group is None else group)


def gather(xs, specs, chain, group=None):
    """The whole arrays from every process's blocks of them, in one
    exchange: ``specs[i] = (regions, shape)``, ``regions[r]`` process r's
    block of array i as ((lo, hi) per dimension).  The backward gives this
    process the sum, in rank order, of the cotangents over its block of the
    processes of ``group`` (sorted ranks, this one included; default every
    process): one replica, where several evaluate the same function."""
    if not xs or len(specs[0][0]) == 1:
        return list(xs)
    return _apply(_Gather, _gather_spec(specs, group), list(xs), chain)



class _GatherReplicated(_Gather):

    @staticmethod
    def backward(ctx, _gtoken, *gs):
        me = rank()
        return (None, _token_grad(ctx)) + tuple(g[_slices(regions[me])] for g, (regions, _) in zip(gs, ctx.spec[0]))


def gather_replicated(xs, specs, chain):
    """``gather``'s whole arrays, for an evaluation that every process runs
    on the whole arrays alike (so every process's cotangent of them is the
    whole gradient): the backward keeps this process's block of its own
    cotangent and exchanges nothing.  ``gather``'s backward, which sums the
    processes' cotangents, would give the gradient times the world size
    there."""
    if not xs or len(specs[0][0]) == 1:
        return list(xs)
    return _apply(_GatherReplicated, _gather_spec(specs, None), list(xs), chain)


# -- Sums of whole vectors --------------------------------------------------


def _allsum(x, group):
    """The ``x`` of the processes of ``group`` summed in rank order (one
    all_gather of every process's)."""
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(world_size())]
    try:
        dist.all_gather(parts, wire)
    except Exception as e:  # noqa: BLE001 -- re-raised as the one error no caller takes
        raise CollectiveError(f"all_gather of a vector to sum failed: {e}") from e
    return _fold([p.to(x.device, non_blocking=True) for p in parts], list(group or range(len(parts))))


class _AllSum(torch.autograd.Function):

    @staticmethod
    def forward(x, group):
        return _allsum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _allsum(x, group), in_dims[0]


def allsum(x, group=None):
    """The sum of every process's ``x`` (a whole vector of one shape on
    every process), added in rank order: the same bits on every process.
    Gauss-Newton's transposed products over processes: each process pulls
    its residual block back to a whole x-space vector, and these are summed.
    ``group``: the sorted ranks whose vectors are summed (default every
    process; one replica where several evaluate the same residual blocks);
    every process still takes part in the exchange.  Its backward is the
    identity (every process differentiates the same function of the sum, as
    for ``psum_table``); under ``torch.func.vmap`` the batch is summed in
    one exchange."""
    if world_size() == 1:
        return x
    return _AllSum.apply(x, tuple(group) if group is not None else None)
