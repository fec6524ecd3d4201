"""odil_torch.parallel and the mesh arguments of Domain against the JAX
package: mesh specs parse to the same axis names and shapes (the port's
mesh on a list of eight CPU devices, JAX's on the conftest's eight virtual
host devices), auto_partition maps the same dimensions, a Domain with a
mesh takes the GSPMD route without halo, and the port rejects what it does
not run (several cards, several processes)."""

import jax
import numpy as np
import pytest
import torch

import odil_torch
from odil_torch import parallel as tpar
from odil_torch.models import veltracer as tvt
from odil_tpu import parallel as jpar

CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize(
    "spec",
    ["x:2,y:4", "t:2,x:2", "x:4", "t:2,x:-1", "x", {"x": 2, "y": 4}, [("t", 4), ("x", 2)], "t:8"],
    ids=["str", "t2x2", "x4", "fill", "bare", "dict", "pairs", "t8"],
)
def test_mesh_from_spec_matches_jax(spec):
    jm = jpar.mesh_from_spec(spec, devices=jax.devices()[:8])
    tm = tpar.mesh_from_spec(spec, devices=CPU8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
    assert all(d == torch.device("cpu") for d in tm.devices.reshape(-1))


def test_mesh_repeats_devices_and_defaults():
    devs = [torch.device("cpu", 0)] * 4
    mesh = tpar.make_mesh(devices=devs)
    assert mesh.axis_names == ("x",) and mesh.devices.shape == (4,)
    assert tpar.make_mesh(devices=CPU8).shape == {"x": 8}
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=devs)
    assert mesh.device_at({"t": 1, "x": 1}) == devs[0]
    assert mesh.device_at({"t": 1}) == devs[0]
    with pytest.raises(AssertionError):
        tpar.mesh_from_spec("t:4,x:4", devices=devs)
    assert tpar.device_count() == torch.cuda.device_count()


def test_mesh_over_distinct_cards_raises(monkeypatch):
    """One card only: the default device list is the first card, and a mesh
    naming two cards raises (their shards are not run on their own cards)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tpar.make_mesh()
    assert mesh.shape == {"x": 1} and mesh.devices[0] == torch.device("cuda", 0)
    mesh = tpar.mesh_from_spec("t:2,x:2", devices=[torch.device("cuda")] * 2 + [torch.device("cuda", 0)] * 2)
    assert mesh.shape == {"t": 2, "x": 2}
    with pytest.raises(NotImplementedError, match="one card"):
        tpar.mesh_from_spec("x:2", devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="one card"):
        tpar.Mesh(np.array([torch.device("cuda", 1), torch.device("cuda", 2)], dtype=object), ("x",))


@pytest.mark.parametrize("spec", ["x:2,y:4", "t:2,x:2", "y:8", "z:2,x:4"])
def test_auto_partition_matches_jax(spec):
    jm = jpar.mesh_from_spec(spec, devices=jax.devices()[:8])
    tm = tpar.mesh_from_spec(spec, devices=CPU8)
    dims = ("t", "x", "y")
    assert tpar.auto_partition(dims, tm) == jpar.auto_partition(dims, jm)


def test_init_distributed_single_process_only():
    """The single-process calls are no-ops: no process group, process 0 of
    1, and meshes of one process (several processes run in
    tests/test_torch_distributed.py)."""
    import torch.distributed as dist

    assert tpar.init_distributed() is None
    assert tpar.init_distributed(num_processes=1) is None
    assert tpar.init_distributed("localhost:1234", num_processes=1, process_id=0) is None
    assert not (dist.is_available() and dist.is_initialized())
    assert (tpar.process_index(), tpar.process_count()) == (0, 1)
    mesh = tpar.mesh_from_spec("t:2,x:4", devices=CPU8)
    assert not mesh.spans_processes and mesh.processes == [0] and (mesh.owners == 0).all()
    assert mesh.box() == {"t": (0, 2), "x": (0, 4)} and mesh.local_device == torch.device("cpu")


def test_init_distributed_needs_a_card_or_device(monkeypatch):
    """Several processes with no card visible and no device named raise
    before any group is made: a process runs on the CPU only when asked."""
    import torch.distributed as dist

    monkeypatch.setattr(tpar, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tpar.init_distributed("localhost:1", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tpar.init_distributed(backend="gloo")
    assert not (dist.is_available() and dist.is_initialized())


def _spanning(spec, nproc, process):
    """The mesh of ``spec`` over CPU entries, owned process-major by
    ``nproc`` processes, seen from ``process``."""
    m = tpar.mesh_from_spec(spec, devices=CPU8)
    owners = np.repeat(np.arange(nproc), m.devices.size // nproc).reshape(m.devices.shape)
    return tpar.Mesh(m.devices, m.axis_names, owners=owners, process=process)


@pytest.mark.parametrize("spec,nproc,boxes", [
    ("t:2,x:4", 2, [{"t": (0, 1), "x": (0, 4)}, {"t": (1, 1), "x": (0, 4)}]),
    ("x:2,t:2", 2, [{"x": (0, 1), "t": (0, 2)}, {"x": (1, 1), "t": (0, 2)}]),
    ("t:2,x:2", 4, [{"t": (i, 1), "x": (j, 1)} for i in range(2) for j in range(2)]),
], ids=["t2x4", "x2t2", "t2x2_one_each"])
def test_mesh_owners_over_processes(spec, nproc, boxes):
    """Each position's owner (process-major, as jax.devices() orders the
    processes' devices) and each process's box."""
    for r in range(nproc):
        mesh = _spanning(spec, nproc, r)
        assert mesh.spans_processes and mesh.processes == list(range(nproc))
        assert mesh.box() == boxes[r] == mesh.box(r)
        assert mesh.local_device == torch.device("cpu")
        for pos in np.ndindex(*mesh.devices.shape):
            index = dict(zip(mesh.axis_names, pos))
            owner = [q for q, box in enumerate(boxes) if all(lo <= index[a] < lo + n for a, (lo, n) in box.items())]
            assert owner == [mesh.owner_at(index)] == [int(mesh.owners[pos])]


def test_mesh_box_check_raises():
    """A process's positions must form a box of the mesh; a process that
    owns none of a spanning mesh's positions cannot use it."""
    devs = np.empty((3, 2), dtype=object)
    devs[:] = torch.device("cpu")
    with pytest.raises(ValueError, match="do not form a box"):
        tpar.Mesh(devs, ("t", "x"), owners=np.repeat([0, 1], 3).reshape(3, 2), process=0)
    with pytest.raises(ValueError, match="owns no position"):
        tpar.Mesh(devs, ("t", "x"), owners=np.repeat([0, 1], 3).reshape(2, 3).T.copy(), process=2)
    mesh = tpar.Mesh(devs, ("t", "x"), owners=np.array([[0, 1]] * 3), process=1)
    assert mesh.box() == {"t": (0, 3), "x": (1, 1)}


@pytest.mark.parametrize("process", range(4))
def test_shard_state_arrays_gives_each_process_its_block(process):
    """On t:2,x:2 over four processes (one shard each) every process holds
    the block of each array that Domain.field_sharding names: the t axis of
    N+1 nodes whole, x halved on the levels that divide, the coarse levels
    that do not divide whole; the state the Domain initializes stays whole."""
    mesh = _spanning("t:2,x:2", 4, process)
    p, s, _ = tvt.build(nt=16, nx=16, ny=16, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                        partition={"t": "t", "x": "x"})
    whole = [torch.arange(a.numel(), dtype=torch.float64).reshape(a.shape) for a in p.domain.arrays_from_state(s)]
    assert [tuple(a.shape) for a in p.domain.arrays_from_state(s)] == [tuple(a.shape) for a in whole]
    mine = tpar.shard_state_arrays(p.domain, whole)
    i_x = process % 2
    assert len(mine) == len(whole) > 2
    for a, b in zip(whole, mine):
        spec = p.domain.field_sharding(shape=tuple(a.shape)).spec
        assert spec[0] is None and spec[2] is None  # node axis of N+1 entries; y unpartitioned
        if a.shape[1] % 2:
            assert spec[1] is None and torch.equal(a, b)
        else:
            assert spec[1] == "x"
            n = a.shape[1] // 2
            assert torch.equal(b, a[:, i_x * n: (i_x + 1) * n])


def test_one_process_routes_raise_over_processes():
    """The routes that still run in one process only say so on a mesh over
    several, before any collective (these meshes have no group): the sparse
    Newton's linearization and a mesh over two cards in one process.  The
    GSPMD route, multi_start on a problem whose domain mesh spans processes
    (every instance in this process's blocks) and Gauss-Newton's halo
    residual map build there."""
    from odil_torch.halo import make_halo_residual_fn
    from odil_torch.models import poisson as tpo

    mesh = _spanning("t:2,x:2", 2, 0)
    p, s, _ = tvt.build(nt=8, nx=16, ny=16, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                        partition={"t": "t", "x": "x"})
    with pytest.raises(NotImplementedError, match="several processes"):
        p.linearize(s)
    assert p._over_processes()
    p.make_loss_fn(s)
    loss_b, stacked = tpar.multi_start(p, s, 2)
    blocks = tpar.shard_state_arrays(p.domain, p.domain.arrays_from_state(s))
    assert loss_b.instances == [0, 1] and loss_b.form == "loop"
    assert [tuple(a.shape) for a in stacked] == [(2,) + tuple(b.shape) for b in blocks]
    pp, ps, _ = tpo.build(n=16, multigrid=False, dtype=np.float64, device="cpu", mesh=_spanning("x:2,y:2", 2, 1),
                          partition={"x": "x", "y": "y"})
    f, x0 = make_halo_residual_fn(pp, ps)
    assert x0.numel() == 16 * 16 and f.term_counts == [16 * 16] and f.term_sizes == [16 * 8]
    with pytest.raises(NotImplementedError, match="one card a process|one process a card"):
        tpar.mesh_from_spec("x:2", devices=[torch.device("cuda", 0), torch.device("cuda", 1)])


def test_domain_checks_the_partition():
    mesh = tpar.mesh_from_spec("t:2,x:4", devices=CPU8)
    d = odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), mesh=mesh, partition={"t": "t", "x": "x"},
                          device="cpu")
    assert d.mesh is mesh and d.partition == {"t": "t", "x": "x"}
    # A partition that does not divide: the GSPMD route replicates the
    # dimension (the JAX package's warning), the halo route refuses it.
    d = odil_torch.Domain((8, 18, 16), dimnames=("t", "x", "y"), mesh=mesh, partition={"x": "x"}, device="cpu")
    assert d.field_sharding(shape=(8, 18, 16)).spec == (None, None, None)
    state = d.init_state(odil_torch.State(fields={"u": None}))
    problem = odil_torch.Problem(lambda ctx: [ctx.field("u", 0, 1, 0) - ctx.field("u")], d)
    with pytest.raises(ValueError, match="not divisible"):
        problem.make_loss_fn(state, halo=True)
    with pytest.raises(ValueError, match="names no grid dimension"):
        odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), mesh=mesh, partition={"z": "x"}, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), partition={"x": "x"}, device="cpu")
    # A mesh without a partition replicates every array (the GSPMD route).
    d = odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), mesh=mesh, device="cpu")
    assert d.mesh is mesh and d.partition is None and d.field_sharding(shape=(8, 16, 16)) is None


def test_mesh_without_halo_raises():
    """A mesh evaluated without halo takes the JAX package's GSPMD route: on
    one device the unsharded loss and gradients, to the bit, through
    make_loss_fn and make_loss_grad_fn; with halo=True the per-shard route."""
    mesh = tpar.mesh_from_spec("x:4", devices=CPU8)
    kw = dict(nt=8, nx=16, ny=16, kernel="pallas", dtype=np.float64, device="cpu")
    p0, s0, _ = tvt.build(**kw)
    p, s, _ = tvt.build(**kw, mesh=mesh, partition={"x": "x"})
    arrays = [a.detach().requires_grad_(True) for a in p.domain.arrays_from_state(s)]
    got = []
    for prob, st in ((p0, s0), (p, s)):
        loss, (terms, _) = prob.make_loss_fn(st)[0](arrays, prob.tracers)
        got.append([loss, *terms, *torch.autograd.grad(loss, arrays)])
    assert all(torch.equal(a, b) for a, b in zip(*got))
    assert p.make_loss_grad_fn(s) is None and p0.make_loss_grad_fn(s0) is None  # fp64: autograd, as unsharded
    assert p.make_loss_fn(s, halo=True)[0] is not None
