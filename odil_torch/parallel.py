"""Device meshes for the halo (per-shard) evaluation path.

PyTorch counterpart of ``odil_tpu/parallel.py``.  The JAX package runs one
SPMD program per device of a ``jax.sharding.Mesh``; the port runs a single
controller that loops over the mesh's shards (``halo.py``), so a mesh here is
only a named grid of ``torch.device``s:

    mesh = parallel.make_mesh("t:2,x:2", devices=[torch.device("cuda")] * 4)  # or dict / pair spec
    domain = Domain(cshape, mesh=mesh, partition={"t": "t", "x": "x"})

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

__all__ = ["Mesh", "make_mesh", "mesh_from_spec", "auto_partition", "init_distributed", "device_count"]


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
