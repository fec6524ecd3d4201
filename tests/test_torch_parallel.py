"""odil_torch.parallel and the mesh arguments of Domain against the JAX
package: mesh specs parse to the same axis names and shapes (the port's
mesh on a list of eight CPU devices, JAX's on the conftest's eight virtual
host devices), auto_partition maps the same dimensions, and the port
rejects what it does not run."""

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
    with pytest.raises(ValueError, match="do not divide"):
        odil_torch.Domain((8, 18, 16), dimnames=("t", "x", "y"), mesh=mesh, partition={"x": "x"}, device="cpu")
    with pytest.raises(ValueError, match="names no grid dimension"):
        odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), mesh=mesh, partition={"z": "x"}, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), partition={"x": "x"}, device="cpu")
    with pytest.raises(NotImplementedError):
        odil_torch.Domain((8, 16, 16), dimnames=("t", "x", "y"), mesh=mesh, device="cpu")


def test_mesh_without_halo_raises():
    """A mesh evaluates per shard (halo=True); the JAX package's GSPMD route,
    which the same Domain takes without halo, is not ported."""
    mesh = tpar.mesh_from_spec("x:4", devices=CPU8)
    p, s, _ = tvt.build(nt=8, nx=16, ny=16, kernel="pallas", dtype=np.float64, device="cpu", mesh=mesh,
                        partition={"x": "x"})
    with pytest.raises(NotImplementedError):
        p.make_loss_fn(s)
    with pytest.raises(NotImplementedError):
        p.make_loss_grad_fn(s)
    assert p.make_loss_fn(s, halo=True)[0] is not None
