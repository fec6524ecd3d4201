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
    assert tpar.init_distributed() is None
    assert tpar.init_distributed(num_processes=1) is None
    with pytest.raises(NotImplementedError):
        tpar.init_distributed("localhost:1234", num_processes=2, process_id=0)


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
