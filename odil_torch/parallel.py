"""Device meshes, shardings and batched starts.

PyTorch counterpart of ``odil_tpu/parallel.py``.  The JAX package runs one
SPMD program per device of a ``jax.sharding.Mesh``; the port runs a single
controller, so a mesh here is only a named grid of ``torch.device``s:

    mesh = parallel.make_mesh("t:2,x:2", devices=[torch.device("cuda")] * 4)  # or dict / pair spec
    domain = Domain(cshape, mesh=mesh, partition={"t": "t", "x": "x"})

Such a Domain takes both of the JAX package's mesh routes:

- without ``halo`` (the GSPMD route) it evaluates exactly as the unsharded
  Domain does: on one card GSPMD's partitioning changes no number, so the
  sharding specs (``Domain.field_sharding``, ``NamedSharding``,
  ``shard_state_arrays``) are computed as the JAX package computes them and
  the arrays stay whole on the mesh's card;
- with ``halo=True`` the controller loops over the mesh's shards
  (``halo.py``).

``multi_start`` batches independent starts of one problem along a leading
instance axis.

The device list defaults to the first card.  An explicit list may repeat a
device: ``[torch.device("cuda")] * 4`` runs four shards on one card, and
``[torch.device("cpu")] * 8`` stands for the JAX package's virtual host
devices (``--xla_force_host_platform_device_count``) in the tests.  The state
stays on the mesh's first device.  A mesh over more than one distinct card
raises ``NotImplementedError``: the per-shard kernels launch on the current
card's streams, and the localization's CUDA graphs are captured on one card.
"""

import numpy as np
import torch

__all__ = [
    "Mesh", "NamedSharding", "PartitionSpec", "make_mesh", "mesh_from_spec", "auto_partition", "init_distributed",
    "device_count", "shard_state_arrays", "replicated", "multi_start",
]


class Mesh:
    """Named mesh axes over a grid of devices.

    axis_names: tuple of axis names; devices: numpy object array of
    ``torch.device`` whose shape gives the axis sizes (``devices.shape``, as
    for ``jax.sharding.Mesh``)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names), (self.devices.shape, self.axis_names)
        cards = {d.index or 0 for d in self.devices.reshape(-1) if d.type == "cuda"}
        if len(cards) > 1:
            raise NotImplementedError(
                f"odil_torch.parallel: a mesh over cards {sorted(cards)}; only one card is supported "
                "(repeat it in the device list for several shards)"
            )

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, index):
        """The device at mesh position ``index`` ({axis name: index}; absent
        axes at 0)."""
        return self.devices[tuple(index.get(n, 0) for n in self.axis_names)]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def device_count():
    """The visible CUDA devices (0 without a card)."""
    return torch.cuda.device_count()


def _default_devices():
    if device_count() == 0:
        raise RuntimeError("no CUDA device is visible: pass devices= (e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", 0)]


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """A no-op for a single process.  Multi-process runs (one process per
    card over ``torch.distributed``) are not ported."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError("odil_torch.parallel: multi-process runs are not ported; use one process")


def mesh_from_spec(spec, devices=None):
    """Builds a Mesh from a spec like "x:2,y:4", {"x": 2, "y": 4}, or
    [("x", 2), ("y", 4)].  Axis sizes must multiply to <= the device count;
    a size of -1 takes all remaining devices."""
    if isinstance(spec, str):
        pairs = []
        for part in spec.split(","):
            name, _, size = part.partition(":")
            pairs.append((name.strip(), int(size) if size else -1))
    elif isinstance(spec, dict):
        pairs = list(spec.items())
    else:
        pairs = [tuple(p) for p in spec]

    devices = list(devices if devices is not None else _default_devices())
    devices = [torch.device(d) for d in devices]
    total = len(devices)
    known = int(np.prod([s for _, s in pairs if s != -1]))
    pairs = [(n, s if s != -1 else max(1, total // known)) for n, s in pairs]
    shape = tuple(s for _, s in pairs)
    names = tuple(n for n, _ in pairs)
    count = int(np.prod(shape))
    assert count <= total, f"Mesh {dict(pairs)} needs {count} devices, have {total}"
    grid = np.empty(count, dtype=object)
    grid[:] = devices[:count]
    return Mesh(grid.reshape(shape), names)


def make_mesh(spec=None, devices=None):
    """Convenience: the default spec shards all devices along one axis 'x'."""
    devices = list(devices if devices is not None else _default_devices())
    return mesh_from_spec(spec if spec is not None else f"x:{len(devices)}", devices)


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
    """A mesh and a partition spec (``jax.sharding.NamedSharding``).  On the
    port's one-card mesh every shard of an array is the whole array on the
    mesh's card, so placing an array moves it there and changes no value."""

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
        return self.mesh.devices.reshape(-1)[0]

    def place(self, array):
        """``array`` on the mesh's card: the same tensor when it lies there."""
        return array.to(self.device)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shard_state_arrays(domain, arrays):
    """Places the grid-rank arrays of ``arrays`` with the domain's sharding
    (``Domain.field_sharding``, per shape: staggered node axes and coarse
    multigrid levels that do not divide their mesh axis replicate along it);
    the others are left as they are.  On one card the arrays that already lie
    on the mesh's card come back as the same tensors."""
    if domain.mesh is None or not domain.partition:
        return arrays
    return [domain.field_sharding(shape=tuple(a.shape)).place(a) if a.ndim == domain.ndim else a for a in arrays]


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
    sharded = mesh is not None and batch_axis is not None
    stacked = []
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
            batched = NamedSharding(mesh, PartitionSpec(batch_axis, *([None] * a.ndim))).place(batched)
        stacked.append(batched)

    def mean(t):
        return torch.mean(t, dim=0)

    if _reaches_kernels(problem, state):

        def loss_fn_b(arrays_b, tracers):
            outs = [loss_fn([a[i] for a in arrays_b], tracers) for i in range(nstarts)]
            losses = torch.stack([loss for loss, _ in outs])
            terms = [torch.stack(t) for t in zip(*[o[1][0] for o in outs])]
            norms = [torch.stack(n) for n in zip(*[o[1][1] for o in outs])]
            return mean(losses), ([mean(t) for t in terms], [mean(n) for n in norms])

        loss_fn_b.form = "loop"
    else:

        def loss_fn_b(arrays_b, tracers):
            def one(*arrs):
                loss, (terms, norms) = loss_fn(list(arrs), tracers)
                return loss, tuple(terms), tuple(norms)

            losses, terms, norms = torch.func.vmap(one)(*arrays_b)
            return mean(losses), ([mean(t) for t in terms], [mean(n) for n in norms])

        loss_fn_b.form = "vmap"
    return loss_fn_b, stacked
