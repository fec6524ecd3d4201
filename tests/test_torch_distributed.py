"""The halo route over several processes (``torch.distributed`` over gloo,
on the CPU) against the JAX package and the port's single controller.

Like ``tests/test_distributed.py``, the test starts worker processes with
``subprocess`` on a free port; the worker is this file run as ``__main__``
and imports ``torch`` and ``odil_torch`` only:

    python tests/test_torch_distributed.py <rank> <world> <port> <out.npz>

Two processes run every case in one launch: the flagship at 16^3 in fp64
(``tests/dcn_worker.py``'s configuration) on ``t:2,x:4`` (2 processes x 4
shards: the t exchange crosses processes) and on ``x:2,t:2`` (2 x 2: the x
exchange crosses processes), each through the loss-only route
(``kernel="xla"``, autograd of ``make_halo_loss_fn``), its global multigrid
ladder, the generic one-pass (``kernel="pallas"``) and the MG-fused route
(``kernel="pallas_mg"``); heat and wave on ``t:4`` (2 x 2) through the
loss-only and generic routes; and 20 Adam epochs through the generic route
on ``t:2,x:4`` and the MG-fused route on ``x:2,t:2``.  Rank 0 writes the loss,
the terms and the gradient gathered whole (``parallel.gather_state_arrays``)
and each rank's digest of every array after Adam.

Held here: loss, terms and gradient within 1e-12 (relative; the gradient's
atol 1e-12 * max|ref|) of the JAX package's ``make_halo_loss_fn`` of the
plain operator on the same mesh of 8 virtual CPU devices, and of the port's
single controller on the same mesh of 8 CPU entries in one process; the
Adam rows within rtol 1e-10 of the single controller's; the arrays that
both processes hold whole with the same bits on both; and a second launch
repeating every number of the first to the bit.
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NPROC = 2
FLAGSHIP = dict(nt=16, nx=16, ny=16, multigrid=True)
SPECS = {"t2x4": ("t:2,x:4", {"t": "t", "x": "x"}), "x2t2": ("x:2,t:2", {"t": "t", "x": "x"})}
# route -> (kernel, how it is evaluated)
ROUTES = {"xla": ("xla", "loss"), "global": ("xla", "global"), "generic": ("pallas", "generic"), "mg": ("pallas_mg", "mg")}
ONE_D = {
    "wave": dict(nt=16, nx=16),
    "heat": dict(nt=16, nx=16, infer_k=True, imposed="random", nimp=40, kxreg=0.3, ktreg=0.2),
}
ONE_D_SPEC = ("t:4", {"t": "t"})
ADAM = {"t2x4": "generic", "x2t2": "mg"}
ADAM_EPOCHS, ADAM_LR = 20, 0.02
SEED = 3
RTOL, ATOL = 1e-12, 1e-12


# -- Shared by the worker and the test --------------------------------------


def _build(name, kernel, mesh, part):
    import torch  # noqa: F401 -- the port's models import it

    from odil_torch.models import heat, veltracer, wave

    if name == "flagship":
        return veltracer.build(kernel=kernel, dtype=np.float64, device="cpu", mesh=mesh, partition=part, **FLAGSHIP)
    build = {"heat": heat.build, "wave": wave.build}[name]
    return build(kernel=kernel, dtype=np.float64, device="cpu", mesh=mesh, partition=part, **ONE_D[name])


def _state_arrays(problem, state):
    """The random state of every case: numpy normal draws of the global
    arrays' shapes."""
    rng = np.random.default_rng(SEED)
    return [0.3 * rng.normal(size=tuple(a.shape)) for a in problem.domain.arrays_from_state(state)]


def _evaluate(problem, state, arrays, how):
    """(loss, terms, grads) of the halo route ``how`` at ``arrays`` (this
    process's arrays)."""
    import torch

    from odil_torch.halo import make_halo_loss_fn

    if how in ("loss", "global"):
        loss_fn, _ = make_halo_loss_fn(problem, state, mg_ladder="global" if how == "global" else "local")
        x = [a.detach().clone().requires_grad_(True) for a in arrays]
        loss, (terms, _) = loss_fn(x, problem.tracers)
        grads = torch.autograd.grad(loss, x)
    else:
        fn = problem.make_loss_grad_fn(state, halo=True, halo_fuse=how)
        assert fn is not None and fn.route == how, (how, fn)
        (loss, (terms, _)), grads = fn(arrays, problem.tracers)
    return loss.detach(), [t.detach() for t in terms], [g.detach() for g in grads]


def _cases():
    """[(case name, model, spec, partition, kernel, how)] in the order the
    worker runs them."""
    out = []
    for sname, (spec, part) in SPECS.items():
        for route, (kernel, how) in ROUTES.items():
            out.append((f"{sname}_{route}", "flagship", spec, part, kernel, how))
    for name in ONE_D:
        for how in ("loss", "generic"):
            out.append((f"{name}_{how}", name, *ONE_D_SPEC, "pallas", how))
    return out


def _adam_rows(problem, state, arrays, route):
    from odil_torch.optim import Adam

    opt = Adam(problem.make_loss_grad_fn(state, halo=True, halo_fuse=route), arrays, lr=ADAM_LR)
    return opt.run_chunk(ADAM_EPOCHS).numpy(), opt.x


# -- The worker ----------------------------------------------------------------


def worker(rank, world, port, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from odil_torch import parallel
    from odil_torch.convert import arrays_from_numpy

    parallel.init_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cpu", timeout=120)
    assert parallel.process_count() == world and parallel.process_index() == rank
    res = {}
    for case, name, spec, part, kernel, how in _cases():
        mesh = parallel.mesh_from_spec(spec)
        problem, state, _ = _build(name, kernel, mesh, part)
        whole = arrays_from_numpy(_state_arrays(problem, state), device="cpu")
        mine = parallel.shard_state_arrays(problem.domain, whole)
        loss, terms, grads = _evaluate(problem, state, mine, how)
        shapes = [tuple(a.shape) for a in whole]
        grads = parallel.gather_state_arrays(problem.domain, grads, shapes)
        res[f"{case}/loss"] = loss.numpy()
        res[f"{case}/terms"] = np.array([t.numpy() for t in terms])
        for i, g in enumerate(grads):
            res[f"{case}/grad{i}"] = g.numpy()
    for sname, route in ADAM.items():
        spec, part = SPECS[sname]
        mesh = parallel.mesh_from_spec(spec)
        problem, state, _ = _build("flagship", ROUTES[route][0], mesh, part)
        whole = arrays_from_numpy(_state_arrays(problem, state), device="cpu")
        sh = [problem.domain.field_sharding(shape=tuple(a.shape)) for a in whole]
        rows, x = _adam_rows(problem, state, parallel.shard_state_arrays(problem.domain, whole), route)
        digests = [hashlib.sha256(a.numpy().tobytes()).hexdigest() for a in x]
        everyone = [None] * world
        dist.all_gather_object(everyone, digests)
        res[f"adam_{sname}/rows"] = rows
        # The arrays whose block is the same on every process (held whole).
        whole_everywhere = [i for i, s in enumerate(sh) if len({s.region(tuple(whole[i].shape), r)
                                                                for r in range(world)}) == 1]
        res[f"adam_{sname}/replicated"] = np.array(whole_everywhere)
        res[f"adam_{sname}/same_bits"] = np.array([len({d[i] for d in everyone}) == 1 for i in whole_everywhere])
        x = parallel.gather_state_arrays(problem.domain, x, [tuple(a.shape) for a in whole])
        for i, a in enumerate(x):
            res[f"adam_{sname}/x{i}"] = a.numpy()
    # The worker ran on torch and odil_torch alone.
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "odil_tpu", "odil")]
    everyone = [None] * world
    dist.all_gather_object(everyone, loaded)
    res["jax_modules"] = np.array([len(m) for m in everyone])
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank} done", flush=True)


# -- The test ------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(out, script=__file__):
    """Starts the workers of one run (``script`` run as ``__main__``, this
    file by default); returns a function that waits for them and reads rank
    0's results."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    logs = [open(f"{out}.{r}.log", "w+") for r in range(NPROC)]  # files, not pipes: no writer waits on a reader
    procs = [
        subprocess.Popen([sys.executable, script, str(r), str(NPROC), str(port), out], env=env, cwd=REPO,
                         stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)
    ]

    def wait():
        try:
            for p in procs:
                p.wait(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            log.seek(0)
            text = log.read()
            log.close()
            assert p.returncode == 0, text[-4000:]
        return dict(np.load(out))

    return wait


def _single():
    """The port's single controller: every case on the mesh of 8 CPU
    entries in this process, and its Adam rows."""
    import torch

    from odil_torch import parallel
    from odil_torch.convert import arrays_from_numpy

    res = {}
    for case, name, spec, part, kernel, how in _cases():
        mesh = parallel.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
        problem, state, _ = _build(name, kernel, mesh, part)
        arrays = arrays_from_numpy(_state_arrays(problem, state), device="cpu")
        res[case] = _evaluate(problem, state, arrays, how)
    for sname, route in ADAM.items():
        spec, part = SPECS[sname]
        mesh = parallel.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
        problem, state, _ = _build("flagship", ROUTES[route][0], mesh, part)
        arrays = arrays_from_numpy(_state_arrays(problem, state), device="cpu")
        res[f"adam_{sname}"] = _adam_rows(problem, state, arrays, route)
    return res


def _jax_refs():
    """The JAX package's halo loss, value and gradient, of the kernel
    problems on the same meshes of 8 virtual CPU devices (its Pallas kernels
    in interpret mode; its XLA optimizations off: at these sizes the compile
    takes the time)."""
    import jax
    import jax.numpy as jnp

    from odil_tpu import halo as jhalo
    from odil_tpu import parallel as jpar
    from odil_tpu.models import heat as jht
    from odil_tpu.models import veltracer as jvt
    from odil_tpu.models import wave as jwv

    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    builds = {"flagship": (jvt.build, FLAGSHIP), "heat": (jht.build, ONE_D["heat"]), "wave": (jwv.build, ONE_D["wave"])}
    refs = {}
    try:
        for key, name, (spec, part) in [(s, "flagship", SPECS[s]) for s in SPECS] + [(n, n, ONE_D_SPEC) for n in ONE_D]:
            build, kw = builds[name]
            jp, js, _ = build(kernel="pallas", dtype=np.float64, mesh=jpar.mesh_from_spec(spec, jax.devices()[:8]),
                              partition=part, **kw)
            rng = np.random.default_rng(SEED)
            arrays = [jnp.asarray(0.3 * rng.normal(size=a.shape)) for a in jp.domain.arrays_from_state(js)]
            loss_fn, _ = jhalo.make_halo_loss_fn(jp, js)
            (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(arrays, jp.tracers)
            refs[key] = (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    return refs


if __name__ != "__main__":
    import pytest

    @pytest.fixture(scope="module")
    def results(tmp_path_factory):
        """Two runs of the workers (the second for the determinism check),
        started together; the single controller's and the JAX package's
        numbers computed while they run."""
        d = tmp_path_factory.mktemp("dist")
        waits = [_launch(str(d / f"run{n}.npz")) for n in range(2)]
        single, refs = _single(), _jax_refs()
        return [w() for w in waits], single, refs

    @pytest.fixture(scope="module")
    def runs(results):
        return results[0]

    @pytest.fixture(scope="module")
    def single(results):
        return results[1]

    @pytest.fixture(scope="module")
    def jax_refs(results):
        return results[2]

    def _close(got_loss, got_terms, got_grads, loss, terms, grads):
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=RTOL)
        assert len(got_terms) == len(terms) and len(got_grads) == len(grads)
        np.testing.assert_allclose(np.asarray(got_terms, dtype=float), np.asarray(terms, dtype=float), rtol=RTOL)
        for a, b in zip(got_grads, grads):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())))

    def _spmd(run, case, n):
        return run[f"{case}/loss"], list(run[f"{case}/terms"]), [run[f"{case}/grad{i}"] for i in range(n)]

    CASES = [c[0] for c in _cases()]

    @pytest.mark.parametrize("case", CASES)
    def test_spmd_matches_single_controller(runs, single, case):
        """Loss, terms and the gathered gradient over 2 processes against
        the port's single controller on the same mesh."""
        loss, terms, grads = single[case]
        _close(*_spmd(runs[0], case, len(grads)), loss.numpy(), [t.numpy() for t in terms],
               [g.numpy() for g in grads])

    @pytest.mark.parametrize("case", CASES)
    def test_spmd_matches_jax(runs, jax_refs, case):
        """The same against the JAX package's make_halo_loss_fn of the plain
        operator on the same mesh of 8 virtual devices."""
        name = case.split("_")[0]
        loss, terms, grads = jax_refs[name]
        _close(*_spmd(runs[0], case, len(grads)), loss, terms, grads)

    @pytest.mark.parametrize("sname", list(ADAM))
    def test_adam_over_processes(runs, single, sname):
        """20 Adam epochs over 2 processes: the rows within rtol 1e-10 of the
        single controller's, the final arrays too, and every array that both
        processes hold whole (on t:2,x:4 all of them) with the same bits on
        both."""
        rows, x = single[f"adam_{sname}"]
        run = runs[0]
        np.testing.assert_allclose(run[f"adam_{sname}/rows"], rows, rtol=1e-10)
        for i, a in enumerate(x):
            b = a.numpy()
            np.testing.assert_allclose(run[f"adam_{sname}/x{i}"], b, rtol=1e-10,
                                       atol=1e-12 * max(1.0, float(np.abs(b).max())))
        if sname == "t2x4":  # each process's box spans x: every array is whole on both
            assert len(run[f"adam_{sname}/replicated"]) == len(x)
        assert run[f"adam_{sname}/same_bits"].all(), run[f"adam_{sname}/replicated"]

    def test_workers_import_no_jax(runs):
        """No worker process loaded jax or the JAX package."""
        assert list(runs[0]["jax_modules"]) == [0] * NPROC

    def test_two_runs_same_bits(runs):
        """A second launch repeats every number of the first to the bit."""
        first, again = runs
        assert sorted(first) == sorted(again)
        differ = [k for k in first if first[k].tobytes() != again[k].tobytes()]
        assert not differ, differ

    def test_layouts_cross_processes(single):
        """The cases are the ones named: on t:2,x:4 each process owns one t
        block (the t exchange crosses processes), on x:2,t:2 one x block."""
        import torch

        from odil_torch import parallel

        for sname, axis in (("t2x4", "t"), ("x2t2", "x")):
            spec, _ = SPECS[sname]
            mesh0 = parallel.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
            owners = np.repeat(np.arange(NPROC), mesh0.devices.size // NPROC).reshape(mesh0.devices.shape)
            mesh = parallel.Mesh(mesh0.devices, mesh0.axis_names, owners=owners, process=0)
            assert mesh.box(0)[axis] == (0, 1) and mesh.box(1)[axis] == (1, 1)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
