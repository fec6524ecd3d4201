"""Device meshes, shardings, processes and batched starts.

PyTorch counterpart of ``odil_tpu/parallel.py``.  The JAX package runs one
SPMD program per device of a ``jax.sharding.Mesh``; the port runs one
program a process, over the mesh positions that the process owns:

    parallel.init_distributed("localhost:1234", 2, rank)        # several processes; no-op for one
    mesh = parallel.make_mesh("t:2,x:2")                         # over every process's entries
    domain = Domain(cshape, mesh=mesh, partition={"t": "t", "x": "x"}, device=parallel.local_device())

A mesh is a named grid of ``torch.device``s and of the processes that own
them (``Mesh.owners``).  In one process it is the single controller's:
``[torch.device("cuda")] * 4`` runs four shards on one card, and
``[torch.device("cpu")] * 8`` stands for the JAX package's virtual host
devices (``--xla_force_host_platform_device_count``) in the tests.  After
``init_distributed`` for several processes, ``mesh_from_spec`` and
``make_mesh`` build the mesh over every process's entries, process-major as
``jax.devices()`` orders them: each process owns ``count / world`` positions
of its own device, and they must form a box of the mesh.

A Domain with a mesh takes both of the JAX package's mesh routes:

- without ``halo`` (the GSPMD route) it evaluates exactly as the unsharded
  Domain does: on one card GSPMD's partitioning changes no number, so the
  sharding specs (``Domain.field_sharding``, ``NamedSharding``) are computed
  as the JAX package computes them and the arrays stay whole on the mesh's
  card.  Over several processes each process holds its blocks, gathers
  the whole arrays and runs the single controller's evaluation
  (``Problem.make_loss_fn``);
- with ``halo=True`` the per-shard route (``halo.py``): in one process the
  controller loops over the mesh's shards; over several, each process runs
  its own shards and exchanges halos and sums with the others
  (``comm.py``).  Each process then holds its block of every array in the
  storage layout of ``Domain.field_sharding`` (``shard_state_arrays``;
  ``gather_state_arrays`` is the inverse): blocks along the dimensions that
  divide their mesh axis, the whole extent along node axes of N+1 entries
  and coarse levels that do not divide.

``multi_start`` batches independent starts of one problem along a leading
instance axis; with its ``batch_axis`` on a mesh over several processes
each process runs its block of the instances, and on a problem whose
domain mesh spans processes each process holds its domain blocks of the
instances and gathers them whole for the batched evaluation.

A mesh over more than one distinct card inside one process raises
``NotImplementedError``: the per-shard kernels launch on the current card's
streams, and the localization's CUDA graphs are captured on one card.  Run
one process a card instead.
"""

import datetime
import os

import numpy as np
import torch

__all__ = [
    "Mesh", "NamedSharding", "PartitionSpec", "make_mesh", "mesh_from_spec", "auto_partition", "init_distributed",
    "process_index", "process_count", "local_device", "device_count", "shard_state_arrays", "gather_state_arrays",
    "replicated", "multi_start",
]

# This process's place among the processes of init_distributed, and each
# process's device (one process, the default card, until it is called).
_PROCESS = {"index": 0, "count": 1, "device": None, "devices": None}


class Mesh:
    """Named mesh axes over a grid of devices and the processes that own
    them.

    axis_names: tuple of axis names; devices: numpy object array of
    ``torch.device`` whose shape gives the axis sizes (``devices.shape``, as
    for ``jax.sharding.Mesh``); owners: the process of each position (same
    shape; default all 0, one process); process: the process this mesh is
    used from (default ``process_index()``; a mesh of one process is its
    owner's)."""

    def __init__(self, devices, axis_names, owners=None, process=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names), (self.devices.shape, self.axis_names)
        self.owners = np.zeros(self.devices.shape, dtype=int) if owners is None else np.asarray(owners, dtype=int)
        assert self.owners.shape == self.devices.shape, (self.owners.shape, self.devices.shape)
        self.processes = sorted({int(r) for r in self.owners.reshape(-1)})
        self.process = int(process) if process is not None else process_index()
        if len(self.processes) == 1:
            self.process = self.processes[0]
        for r in self.processes:
            mine = self.devices[self.owners == r]
            cards = {d.index or 0 for d in mine if d.type == "cuda"}
            if len(cards) > 1:
                raise NotImplementedError(
                    f"odil_torch.parallel: process {r} holds a mesh over cards {sorted(cards)}; a process runs "
                    "on one card (repeat it in the device list for several shards, or run one process a card "
                    "with parallel.init_distributed)"
                )
            self.box(r)  # raises unless the positions form a box
        if self.spans_processes and self.process not in self.processes:
            raise ValueError(f"odil_torch.parallel: process {self.process} owns no position of the mesh")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self):
        """Whether the positions belong to more than one process."""
        return len(self.processes) > 1

    def device_at(self, index):
        """The device at mesh position ``index`` ({axis name: index}; absent
        axes at 0)."""
        return self.devices[tuple(index.get(n, 0) for n in self.axis_names)]

    def owner_at(self, index):
        """The process that owns mesh position ``index`` (absent axes at 0)."""
        return int(self.owners[tuple(index.get(n, 0) for n in self.axis_names)])

    def box(self, process=None):
        """{axis name: (first index, count)} of the positions that
        ``process`` (default: this mesh's) owns; ValueError unless they form
        a box of the mesh."""
        process = self.process if process is None else process
        where = np.argwhere(self.owners == process)
        if not len(where):
            raise ValueError(f"odil_torch.parallel: process {process} owns no position of the mesh")
        lo, hi = where.min(axis=0), where.max(axis=0) + 1
        if int(np.prod(hi - lo)) != len(where):
            raise ValueError(
                f"odil_torch.parallel: the positions of process {process} do not form a box of the mesh "
                f"{self.shape}: {[tuple(int(i) for i in w) for w in where]}"
            )
        return {n: (int(a), int(b - a)) for n, a, b in zip(self.axis_names, lo, hi)}

    @property
    def local_device(self):
        """The device of this process's positions."""
        return self.devices[self.owners == self.process].reshape(-1)[0]

    def __repr__(self):
        procs = f", processes={self.processes}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))}{procs})"


def device_count():
    """The visible CUDA devices (0 without a card)."""
    return torch.cuda.device_count()


def process_index():
    """This process's index among those of ``init_distributed`` (0 for one;
    ``jax.process_index``)."""
    return _PROCESS["index"]


def process_count():
    """The number of processes (``jax.process_count``)."""
    return _PROCESS["count"]


def local_device():
    """This process's device: the card ``init_distributed`` set, else the
    first card (``jax.local_devices()[0]``)."""
    if _PROCESS["device"] is not None:
        return _PROCESS["device"]
    return _default_devices()[0]


def _default_devices():
    if device_count() == 0:
        raise RuntimeError("no CUDA device is visible: pass devices= (e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", 0)]


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, backend=None, device=None,
                     timeout=300.0):
    """Joins this process to the others over ``torch.distributed``
    (``odil_tpu/parallel.py:35``, ``jax.distributed.initialize``).  A no-op
    for one process, unless ``backend`` is named: then a group of one is
    made, and the collectives run through that backend.

    coordinator_address: "host:port" of process 0's rendezvous;
    num_processes, process_id: the world size and this process's rank.
    backend: "nccl" or "gloo"; None takes "nccl" on a card and "gloo" on the
    CPU (the counterpart of ``jax_cpu_collectives_implementation``).
    Processes that share one card name "gloo": NCCL refuses two ranks on one
    card.  device: this process's device; None takes the card
    ``(LOCAL_RANK or process_id) % device_count()`` (set as the current
    card before any other CUDA call), and raises where no card is visible:
    a process runs on the CPU only when ``device="cpu"`` says so.
    timeout: seconds a collective may wait for the others."""
    if (num_processes is None or num_processes <= 1) and backend is None:
        return
    import torch.distributed as dist

    from . import comm

    num_processes = int(num_processes or 1)
    process_id = int(process_id or 0)
    if device is None:
        if device_count() == 0:
            raise RuntimeError("init_distributed: no CUDA device is visible: pass device='cpu'")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_distributed: backend='nccl' needs a card")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address or 'localhost:12355'}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=float(timeout)),
    )
    devices = [None] * num_processes
    dist.all_gather_object(devices, str(device))
    _PROCESS.update(index=process_id, count=num_processes, device=device, devices=[torch.device(d) for d in devices])
    print(f"init_distributed: process {process_id} of {num_processes}, backend {backend}, device {device}, "
          f"transport {comm.transport()}", flush=True)


def mesh_from_spec(spec, devices=None):
    """Builds a Mesh from a spec like "x:2,y:4", {"x": 2, "y": 4}, or
    [("x", 2), ("y", 4)].  Axis sizes must multiply to <= the device count;
    a size of -1 takes all remaining devices.

    After ``init_distributed`` for several processes the default device list
    holds every process's entries, process-major, ``count / world`` of each
    (a size of -1 counts one entry a process), and the positions are owned
    in that order; an explicit list is read the same way."""
    if isinstance(spec, str):
        pairs = []
        for part in spec.split(","):
            name, _, size = part.partition(":")
            pairs.append((name.strip(), int(size) if size else -1))
    elif isinstance(spec, dict):
        pairs = list(spec.items())
    else:
        pairs = [tuple(p) for p in spec]

    world = process_count()
    known = int(np.prod([s for _, s in pairs if s != -1]))
    if devices is None and world > 1:
        total = max(world, known)
    else:
        devices = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
        total = len(devices)
    pairs = [(n, s if s != -1 else max(1, total // known)) for n, s in pairs]
    shape = tuple(s for _, s in pairs)
    names = tuple(n for n, _ in pairs)
    count = int(np.prod(shape))
    if world > 1:
        if count % world:
            raise ValueError(f"Mesh {dict(pairs)}: {count} positions do not divide among {world} processes")
        per = count // world
        if devices is None:
            devices = [d for d in _PROCESS["devices"] for _ in range(per)]
        owners = np.repeat(np.arange(world), per)
    else:
        owners = np.zeros(count, dtype=int)
    assert count <= len(devices), f"Mesh {dict(pairs)} needs {count} devices, have {len(devices)}"
    grid = np.empty(count, dtype=object)
    grid[:] = devices[:count]
    return Mesh(grid.reshape(shape), names, owners=owners.reshape(shape))


def make_mesh(spec=None, devices=None):
    """Convenience: the default spec shards all devices along one axis 'x'
    (one position a process after ``init_distributed``)."""
    if devices is None and process_count() > 1:
        return mesh_from_spec(spec if spec is not None else f"x:{process_count()}")
    devices = list(devices if devices is not None else _default_devices())
    return mesh_from_spec(spec if spec is not None else f"x:{len(devices)}", devices)


def refuse_processes(mesh, what, instead):
    """NotImplementedError for a route that runs in one process only, on a
    mesh over several."""
    if mesh is not None and mesh.spans_processes:
        raise NotImplementedError(f"odil_torch: {what} over several processes is not ported; {instead}")


def auto_partition(domain_dimnames, mesh):
    """Maps grid dimension names onto mesh axis names by name match, e.g.
    dimnames ('t','x','y') with mesh axes ('x','y') -> {'x':'x','y':'y'}."""
    names = set(mesh.axis_names)
    return {d: d for d in domain_dimnames if d in names}


class PartitionSpec(tuple):
    """One entry a dimension: the mesh axis name that shards it, or None
    (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A mesh and a partition spec (``jax.sharding.NamedSharding``).  On a
    mesh of one process every shard of an array is the whole array on the
    mesh's card, so placing an array moves it there and changes no value;
    on a mesh over several processes placing it gives this process its
    block."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        for entry in self.spec:
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None and name not in mesh.axis_names:
                    raise ValueError(f"NamedSharding: {name!r} is not an axis of the mesh {mesh.axis_names}")

    @property
    def is_fully_replicated(self):
        """True when no mesh axis of more than one device shards a dimension."""
        sizes = self.mesh.shape
        names = [n for e in self.spec for n in (e if isinstance(e, tuple) else (e,)) if n is not None]
        return int(np.prod([sizes[n] for n in names])) == 1

    @property
    def device(self):
        return self.mesh.local_device

    def region(self, shape, process=None):
        """((lo, hi) per dimension) of ``process``'s block (default: the
        mesh's own) of an array of ``shape``: along a dimension that a mesh
        axis shards, the positions of the process's box along that axis."""
        box = self.mesh.box(process)
        sizes = self.mesh.shape
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            if entry is None:
                out.append((0, n))
                continue
            if isinstance(entry, tuple):
                raise NotImplementedError(f"NamedSharding: a dimension over several mesh axes {entry}")
            if n % sizes[entry]:
                raise ValueError(f"NamedSharding: size {n} does not divide mesh axis {entry!r} ({sizes[entry]})")
            b = n // sizes[entry]
            lo, cnt = box[entry]
            out.append((lo * b, (lo + cnt) * b))
        return tuple(out)

    def place(self, array):
        """``array`` (the whole array) on this process: on one process the
        array on the mesh's card, the same tensor when it lies there; over
        several, this process's block on its device."""
        if self.mesh.spans_processes:
            for d, (lo, hi) in enumerate(self.region(tuple(array.shape))):
                if (lo, hi) != (0, array.shape[d]):
                    array = array.narrow(d, lo, hi - lo)
        return array.to(self.device)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shard_state_arrays(domain, arrays):
    """Places the grid-rank arrays of ``arrays`` with the domain's sharding
    (``Domain.field_sharding``, per shape: staggered node axes and coarse
    multigrid levels that do not divide their mesh axis replicate along it);
    the others are left as they are.  On one card the arrays that already lie
    on the mesh's card come back as the same tensors; over several processes
    each process gets its block of each array."""
    if domain.mesh is None or not domain.partition:
        return arrays
    return [domain.field_sharding(shape=tuple(a.shape)).place(a) if a.ndim == domain.ndim else a for a in arrays]


def gather_state_arrays(domain, arrays, shapes, grad=False):
    """The whole arrays from every process's blocks (``shard_state_arrays``'s
    inverse; ``shapes``: the whole arrays' shapes), on every process.  A
    collective: every process calls it with the same shapes.  With
    ``grad=True`` differentiable, for an evaluation that every process runs
    whole alike (``comm.gather_replicated``: the backward keeps this
    process's block of its own cotangent); else under ``no_grad``."""
    if domain.mesh is None or not domain.partition or not domain.mesh.spans_processes:
        return list(arrays)
    from . import comm

    out = list(arrays)
    grid = [i for i, a in enumerate(arrays) if a.ndim == domain.ndim]
    specs = []
    for i in grid:
        sh = domain.field_sharding(shape=tuple(shapes[i]))
        specs.append(([sh.region(tuple(shapes[i]), r) for r in domain.mesh.processes], tuple(shapes[i])))
    blocks = [arrays[i] for i in grid]
    if grad:
        got = comm.gather_replicated(blocks, specs, comm.Chain())
    else:
        with torch.no_grad():
            got = comm.gather(blocks, specs, comm.Chain())
    for i, a in zip(grid, got):
        out[i] = a
    return out


def replicated(mesh):
    """The fully replicated sharding on ``mesh`` (for scalars and small
    parameters)."""
    return NamedSharding(mesh, PartitionSpec())


def _reaches_kernels(problem, state):
    """Whether ``Problem.loss_terms`` reaches a kernel: the operator, run once
    on ``state`` as ``loss_terms`` runs it (the level-1 partials where the
    problem asks for them) with its row-wise calls recorded instead of run,
    records a call or returns a ``Context.Raw`` term (the mg kernels' terms
    and any other hand-made mean)."""
    from .context import Context

    arrays = problem.domain.arrays_from_state(state)
    partials = {} if problem.mg_partial else None
    with torch.no_grad():
        st = problem._flatten_multigrid_batched(problem.state_from_arrays(arrays), partial_out=partials)
        ctx = Context(problem.domain, st, extra=problem.extra, tracers=problem.tracers)
        ctx.mg_partials = partials or {}
        ctx.rowwise_defer = True
        _, values = problem._run_operator(ctx)
    return bool(ctx.rowwise_calls) or any(isinstance(v, Context.Raw) for v in values)


def multi_start(problem, state, nstarts, seed=0, scale=1.0, mesh=None, batch_axis=None, per_instance=None):
    """Data parallelism over independent instances of one problem
    (``odil_tpu/parallel.py:109``): ``nstarts`` starts batched along a
    leading instance axis.

    Returns ``(loss_fn_b, stacked)``: ``loss_fn_b(arrays_b, tracers) ->
    (loss, (terms, norms))`` is the batch mean of the instances' losses,
    terms and norms, so it binds into the optimizers as a ``loss_fn`` does
    (their updates act element by element, so per instance).  The starts are
    the state plus ``scale`` times standard normal draws from a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so the card and the
    CPU draw the same starts); start 0 is the state itself.  With ``mesh``
    and ``batch_axis`` the instance axis is given that mesh axis
    (``NamedSharding``); on the port's one-card mesh the instances sit on the
    mesh's card.

    Over several processes (a ``mesh`` whose ``batch_axis`` positions belong
    to several) each process holds a contiguous block of the instances
    (``stacked`` is its block): every process draws all ``nstarts`` starts
    from the seeded generator and keeps its own, so instance i is the same
    for any number of processes.  ``loss_fn_b`` evaluates the process's
    instances, gathers every instance's loss, terms and norms into one table
    in instance order (``comm.psum_table``) and takes the mean of each
    column as the single controller takes it; its backward keeps the
    process's own rows.

    A problem whose domain mesh spans processes holds each instance in the
    domain's blocks: ``stacked`` is this process's block of each stacked
    array, along the domain's partition and, with ``batch_axis`` (an axis
    of the domain's own mesh, which ``mesh`` must then be), along the
    instances.  Without ``batch_axis`` every process holds every instance.
    ``loss_fn_b`` gathers the stacked arrays whole outside the batched
    evaluation (``comm.gather_replicated``, as the GSPMD route gathers, so
    that no collective runs under ``torch.func``), evaluates every instance
    as the single controller does, and its backward keeps this process's
    block of each instance's gradient.

    per_instance: optional {field name: array of shape (nstarts, *field)}
    giving each instance its own value of that unknown (the idiom for batched
    inverse problems: data in a frozen Field, overridden here).  Only
    single-array fields (Field, Array) can be overridden.

    The form of ``loss_fn_b`` is chosen here, from the problem: where the
    loss is plain torch it is ``torch.func.vmap`` of the problem's
    ``loss_fn``, so an evaluation runs each operation once for all
    instances; where it reaches a kernel (``_reaches_kernels``: the
    row-wise kernels' ``_RowwiseSumsq`` and the mg kernels' ``_SumsqMG``,
    autograd Functions without a vmap rule) it is a loop of single-instance
    calls, each launching the kernel as the single-start run does."""
    from .fields import field_arrays

    domain = problem.domain
    spatial = problem._over_processes()
    if spatial:
        # The single controller's loss on the whole arrays, and the whole
        # state's arrays: the stacked blocks are gathered before it.
        def loss_fn(arrays, tracers):
            loss, terms, norms = problem.loss_terms(arrays, tracers)
            return loss, (terms, norms)

        problem._capture_structure(state)
        arrays = domain.arrays_from_state(state)
        if batch_axis is not None:
            if mesh is not None and mesh is not domain.mesh:
                raise ValueError("multi_start: with a domain mesh over several processes the batch axis is an axis "
                                 "of the domain's own mesh; pass mesh=problem.domain.mesh")
            if batch_axis not in domain.mesh.axis_names or batch_axis in domain.partition.values():
                raise ValueError(f"multi_start: batch axis {batch_axis!r} must be an axis of the domain's mesh "
                                 f"{domain.mesh.axis_names} that partitions no grid dimension")
        mesh = domain.mesh
    else:
        loss_fn, arrays = problem.make_loss_fn(state)
    index_of, pos = {}, 0
    for name, fobj in state.fields.items():
        n = len(field_arrays(fobj))
        index_of[name] = (pos, n)
        pos += n
    overrides = {}
    for name, value in (per_instance or {}).items():
        if name not in index_of:
            raise KeyError(f"per_instance: unknown field '{name}'")
        start, n = index_of[name]
        if n != 1:
            raise ValueError(
                f"per_instance: field '{name}' has {n} arrays (multigrid/NN); only single-array fields can be "
                "overridden"
            )
        value = torch.as_tensor(value)
        if value.shape[0] != nstarts:
            raise ValueError(f"per_instance['{name}']: leading dim {value.shape[0]} != nstarts {nstarts}")
        overrides[start] = value

    generator = torch.Generator(device="cpu").manual_seed(int(seed))
    sharded = mesh is not None and (batch_axis is not None or spatial)
    spread = sharded and mesh.spans_processes and not spatial
    if sharded and mesh.spans_processes:
        batch = NamedSharding(mesh, PartitionSpec(batch_axis))
        index = [list(range(*batch.region((nstarts,), r)[0])) for r in mesh.processes]
        mine = index[mesh.processes.index(mesh.process)]
    else:
        mine = list(range(nstarts))
    stacked, gathers = [], []
    for i, a in enumerate(arrays):
        if i in overrides:
            batched = overrides[i].to(device=a.device, dtype=a.dtype)
            if tuple(batched.shape[1:]) != tuple(a.shape):
                raise ValueError(f"per_instance array {tuple(batched.shape[1:])} != field shape {tuple(a.shape)}")
        else:
            noise = scale * torch.randn((nstarts,) + tuple(a.shape), generator=generator, dtype=a.dtype)
            noise[0] = 0.0
            batched = a.detach()[None] + noise.to(a.device)
        if sharded:
            inner = [None] * a.ndim
            if spatial and a.ndim == domain.ndim:
                inner = list(domain.field_sharding(shape=tuple(a.shape)).spec)
            sharding = NamedSharding(mesh, PartitionSpec(batch_axis, *inner))
            shape = tuple(batched.shape)
            gathers.append(([sharding.region(shape, r) for r in mesh.processes], shape))
            batched = sharding.place(batched)
        stacked.append(batched)

    def mean(t):
        return torch.mean(t, dim=0)

    def batch_mean(losses, terms, norms):
        """The means over every instance of the process's instances'
        (losses, terms, norms); over processes through one table of all."""
        if spread:
            from . import comm

            cols = [losses] + list(terms) + list(norms)
            table = comm.psum_table(torch.stack(cols, dim=1), index, nstarts)
            cols = [c.contiguous() for c in table.unbind(1)]
            losses, terms, norms = cols[0], cols[1: 1 + len(terms)], cols[1 + len(terms):]
        return mean(losses), ([mean(t) for t in terms], [mean(n) for n in norms])

    def whole(arrays_b):
        """The stacked arrays whole, where the domain's mesh spans processes."""
        if not spatial:
            return arrays_b
        from . import comm

        return comm.gather_replicated(list(arrays_b), gathers, comm.Chain())

    if _reaches_kernels(problem, state):

        def loss_fn_b(arrays_b, tracers):
            arrays_b = whole(arrays_b)
            outs = [loss_fn([a[i] for a in arrays_b], tracers) for i in range(len(arrays_b[0]))]
            losses = torch.stack([loss for loss, _ in outs])
            terms = [torch.stack(t) for t in zip(*[o[1][0] for o in outs])]
            norms = [torch.stack(n) for n in zip(*[o[1][1] for o in outs])]
            return batch_mean(losses, terms, norms)

        loss_fn_b.form = "loop"
    else:

        def loss_fn_b(arrays_b, tracers):
            def one(*arrs):
                loss, (terms, norms) = loss_fn(list(arrs), tracers)
                return loss, tuple(terms), tuple(norms)

            losses, terms, norms = torch.func.vmap(one)(*whole(arrays_b))
            return batch_mean(losses, terms, norms)

        loss_fn_b.form = "vmap"
    loss_fn_b.instances = mine
    return loss_fn_b, stacked
