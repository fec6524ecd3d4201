"""The routes beside ``--halo`` over several processes (``torch.distributed``
over gloo, on the CPU): the GSPMD route (a mesh that spans processes,
evaluated without ``halo``), Gauss-Newton over processes, ``multi_start``
with its batch axis over processes or on a domain mesh that spans them,
the on-device L-BFGS over processes, and ``--halo`` on a mesh with an axis
that partitions no grid dimension.

Like ``tests/test_torch_distributed.py``, the test starts two worker
processes with ``subprocess`` on a free port; the worker is this file run
as ``__main__`` and imports ``torch`` and ``odil_torch`` only:

    python tests/test_torch_distributed_routes.py <rank> <world> <port> <out.npz>

Each worker runs every case on the mesh that spans the two processes and,
in the same process, the port's single controller (the unsharded problem:
the GSPMD route's numbers on one card), so the bitwise comparisons meet the
same thread count.  The cases:

- GSPMD, plain operator: ``tests/dcn_worker.py``'s flagship (16^3 fp64,
  ``kernel="xla"``) on ``t:2,x:4`` (2 processes x 4 entries); the same
  problem on ``t:2,q:4``, whose axis ``q`` partitions no grid dimension;
- GSPMD, kernel routes: ``pallas`` and ``pallas_mg`` (fp32, the kernels'
  plain versions on the CPU), through ``make_loss_grad_fn`` (the fused
  routes) and autograd of ``make_loss_fn`` (through
  ``comm.gather_replicated``, whose backward would double the gradient
  over two processes if it summed);
- GSPMD, operators that read across blocks: heat 16^2 (fp64, ``xla``) on
  ``t:4`` and on ``t:2,x:2`` (its initial row is rolled along x), and
  poisson 16^2 with a ``roll`` of its field and with a term sliced along a
  partitioned dimension;
- 20 Adam epochs on the GSPMD route (on blocks, and on a mesh whose
  processes hold the whole arrays), and the training harness
  (``util.optimize``) with Adam and GD, its callback fed the whole state on
  every process;
- Gauss-Newton: poisson 16^2 fp64 on ``x:2,y:2`` (2 shards a process)
  under ``--halo`` with plain CG, Jacobi and the V-cycle, and without
  ``--halo`` (the GSPMD route's residual map), 2 epochs;
- ``multi_start`` with 4 starts on ``b:2`` (2 instances a process):
  poisson 16^2 (fp64, vmap) and heat 16^2 ``pallas`` (fp32, the kernel
  loop), 5 Adam epochs, and the batched loss and gradient at numpy-drawn
  starts;
- the L-BFGS (``util.optimize(args, "lbfgs", ...)``, 8 iterations):
  poisson 16^2 fp64 on ``x:2,y:2``, the plain flagship 16^3 fp64 and the
  ``pallas_mg`` flagship 8x16x16 fp32 on ``x:2,t:4`` (the GSPMD route),
  wave 16^2 fp64 under ``--halo`` on ``t:2``;
- ``multi_start`` on a domain mesh over the processes: poisson 16^2 on
  ``x:2,y:2`` without a batch axis, heat 16^2 ``pallas`` on ``b:2,t:2``
  (the domain's t on t, the instances on b) with a process a b index or a
  t index;
- ``--halo`` with an idle axis: the plain flagship 16^3 fp64 on
  ``t:2,q:2`` and ``q:2,t:2`` (the processes replicas of each other).

Every process gathers the whole arrays and evaluates the single
controller's loss on them (``Problem.make_loss_fn``).  Held here: the plain
GSPMD loss and gradient within 1e-12 of the JAX package's unsharded
``make_loss_fn``, and the ``pallas_mg`` ones within the fp32 tolerance of
its fused route and of autograd of its ``make_loss_fn`` (its kernels in
interpret mode); every GSPMD case's loss, terms and gradient equal to the
single controller's to the bit, the Adam and the harness's rows within
rtol 1e-10 of its (to the bit where the processes hold the whole arrays),
and the arrays that both processes hold whole with the
same bits on both; the
plain-CG Gauss-Newton rows under ``--halo`` within 1e-9 of the JAX
package's ``make_halo_residual_fn`` with ``optimize_gauss_newton``, every
case's within 1e-9 of the single controller's, and every process's iterate
with the same bits at each epoch; ``multi_start`` instance by instance
against the single controller, and its batched loss and gradient against
the JAX package's ``multi_start`` on a ``b:2`` mesh of virtual CPU devices
(fp64 1e-12, fp32 1e-5); the L-BFGS rows equal to the single controller's
to the bit on the GSPMD route and within rtol 1e-10 under ``--halo``, the
whole state the same bits on both processes after every iteration, and
poisson's rows within 1e-10 of the JAX package's ``LbfgsOptimizer`` on 4
virtual CPU devices; ``multi_start`` on a spanning domain mesh instance by
instance against the single controller (the loss and every gradient block
to the bit) and the JAX package's on the same mesh of virtual CPU
devices; the idle axis's loss, terms and gradient within 1e-12 of the JAX
package's ``make_halo_loss_fn`` on ``t:2,q:2`` and equal to the port's
one-process ``t:2`` to the bit; and a second launch repeating every
number of the first to the bit.
"""

import argparse
import hashlib
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NPROC = 2
FLAGSHIP = dict(nt=16, nx=16, ny=16, multigrid=True)
PART = {"t": "t", "x": "x"}
# case -> (mesh spec, partition, kernel, dtype)
# On t:2,x:4 each process holds its t-half of the positions, and the
# flagship's node-located t axis (17 nodes) replicates: each holds the whole
# arrays.  On x:2,t:4 each holds an x-half of the fine levels.
GSPMD = {
    "xla": ("t:2,x:4", PART, "xla", np.float64),
    "xla_x": ("x:2,t:4", PART, "xla", np.float64),
    "idle": ("t:2,q:4", {"t": "t"}, "xla", np.float64),
    "pallas": ("x:2,t:4", PART, "pallas", np.float32),
    "pallas_mg": ("x:2,t:4", PART, "pallas_mg", np.float32),
}
WHOLE = ("xla", "idle")  # the cases whose processes hold the whole arrays
# Operators that read across the blocks of a partitioned dimension.
CROSS = ("heat_t", "heat_tx", "poisson_roll", "poisson_sliced")
# Adam's cases: the fp64 plain route on blocks, the fp32 pallas_mg route on
# the mesh whose processes hold the whole arrays (case -> mesh spec).
ADAM = {"xla_x": GSPMD["xla_x"][0], "pallas_mg": GSPMD["xla"][0]}
ADAM_EPOCHS, ADAM_LR = 20, 0.02
HARNESS, HARNESS_EPOCHS = ("adam", "gd"), 4
POISSON = dict(n=16, ref="osc", rhs="exact", multigrid=False)
# case -> (halo, linsolver, CG budget)
GN = {"halo_cg": (1, "", 20), "halo_jacobi": (1, "cg", 20), "halo_vcycle": (1, "vcycle", 10), "gspmd_cg": (0, "", 20)}
GN_EPOCHS = 2
STARTS, STARTS_EPOCHS = 4, 5
MS_SCALE = {"poisson": 0.5, "heat": 0.05}
SEED = 3
# The on-device L-BFGS over processes: case -> (model, mesh spec, halo).
LBFGS = {"poisson": ("poisson", "x:2,y:2", 0), "xla": ("flagship", "x:2,t:4", 0),
         "wave_halo": ("wave", "t:2", 1), "pallas_mg": ("flagship8", "x:2,t:4", 0)}
LBFGS_ITERS = 8
# multi_start on a domain mesh that spans the processes: case -> (model, mesh
# spec, owners or None for process-major, batch axis).  "a": every process
# holds every instance on its domain blocks; "b_b"/"b_t": one mesh for the
# domain (t) and the instances (b), a process a b index or a t index.
MS_SPATIAL = {"a": ("poisson", "x:2,y:2", None, None), "b_b": ("heat", "b:2,t:2", None, "b"),
              "b_t": ("heat", "b:2,t:2", [[0, 1], [0, 1]], "b")}
# --halo on a mesh with an axis (q) that partitions no grid dimension: a
# process a t index (q inside each process), and a process a q index (the
# two processes replicas of each other).
IDLE = ("t:2,q:2", "q:2,t:2")


# -- Shared by the worker and the test --------------------------------------


def _flagship(case, mesh=None, single=False):
    import torch  # noqa: F401 -- the port's models import it

    from odil_torch.models import veltracer

    spec, part, kernel, dtype = GSPMD[case]
    return veltracer.build(kernel=kernel, dtype=dtype, device="cpu", mesh=None if single else mesh,
                           partition=None if single else part, **FLAGSHIP)


def _state_arrays(problem, state, dtype):
    """The random state of every flagship case: numpy normal draws of the
    global arrays' shapes."""
    rng = np.random.default_rng(SEED)
    return [(0.3 * rng.normal(size=tuple(a.shape))).astype(dtype) for a in problem.domain.arrays_from_state(state)]


def _cross(case, mesh=None):
    """The problem of a ``CROSS`` case, on ``mesh`` or unsharded."""
    import torch

    from odil_torch import Problem
    from odil_torch.models import heat as th
    from odil_torch.models import poisson as tpo

    if case.startswith("heat"):
        part = {"t": "t"} if case == "heat_t" else {"t": "t", "x": "x"}
        return th.build(nt=16, nx=16, infer_k=True, imposed="random", nimp=20, kernel="xla", dtype=np.float64,
                        device="cpu", mesh=mesh, partition=part if mesh else None)
    p, state, extra = tpo.build(dtype=np.float64, device="cpu", mesh=mesh,
                                partition={"x": "x", "y": "y"} if mesh else None, **POISSON)

    def rolled(ctx):
        u = ctx.field("u")
        return [torch.roll(u, 1, 0) - 2 * u + torch.roll(u, -1, 0) - ctx.extra.rhs]

    def sliced(ctx):
        u = ctx.field("u")
        return [ctx.field("u", 1, 0) - u, u[1:]]

    return Problem(rolled if case == "poisson_roll" else sliced, p.domain, p.extra), state, extra


def _ms_build(name, odil):
    """The problem of a ``multi_start`` case in the package ``odil``
    (``odil_torch`` or ``odil_tpu``)."""
    import importlib

    mod = importlib.import_module(f"{odil}.models.{name}")
    kw = {"device": "cpu"} if odil == "odil_torch" else {}
    if name == "poisson":
        return mod.build(dtype=np.float64, **POISSON, **kw)
    return mod.build(nt=16, nx=16, infer_k=True, imposed="random", nimp=20, kernel="pallas", dtype=np.float32, **kw)


def _ms_starts(problem, state):
    """The numpy-drawn starts at which both packages' batched losses are
    compared: (STARTS, *shape) for every array of the state."""
    rng = np.random.default_rng(SEED + 1)
    dtype = np.dtype(problem.domain.dtype)
    return [(0.3 * rng.normal(size=(STARTS,) + tuple(np.shape(a)))).astype(dtype)
            for a in problem.domain.arrays_from_state(state)]


def _gn_args(halo, linsolver, maxiter):
    return argparse.Namespace(
        epochs=GN_EPOCHS, epoch_start=0, linsolver=linsolver, linsolver_tol=1e-12, linsolver_damp=0.0,
        linsolver_dampdiag=0, linsolver_maxiter=maxiter, linsolver_precond_every=0, seed=0, nlvl=100,
        smooth_pre=3, ndirect=3, halo=halo,
    )


def _lbfgs_build(model, mesh=None):
    """The problem of an L-BFGS case in the port (``mesh``: None for the
    single controller), its state random where the model's is not."""
    from odil_torch.convert import arrays_from_numpy
    from odil_torch.models import poisson as tpo
    from odil_torch.models import veltracer
    from odil_torch.models import wave as tw

    part = {"x": "x", "y": "y"} if model == "poisson" else {"t": "t"} if model == "wave" else PART
    kw = dict(device="cpu", mesh=mesh, partition=part if mesh is not None else None)
    if model == "poisson":
        return tpo.build(dtype=np.float64, **POISSON, **kw)
    if model == "wave":
        return tw.build(nt=16, nx=16, dtype=np.float64, kernel="pallas", **kw)
    if model == "flagship":
        problem, state, extra = veltracer.build(kernel="xla", dtype=np.float64, **FLAGSHIP, **kw)
    else:
        problem, state, extra = veltracer.build(nt=8, nx=16, ny=16, kernel="pallas_mg", dtype=np.float32, **kw)
    dtype = np.dtype(problem.domain.dtype)
    problem.domain.arrays_to_state(arrays_from_numpy(_state_arrays(problem, state, dtype), device="cpu"), state)
    return problem, state, extra


def _lbfgs_args(halo):
    return argparse.Namespace(epochs=LBFGS_ITERS, epoch_start=0, lr=1e-3, halo=halo)


def _ms_spatial_build(model, odil, mesh=None):
    """The problem of a ``MS_SPATIAL`` case in the package ``odil``, on
    ``mesh`` (None: unsharded)."""
    import importlib

    mod = importlib.import_module(f"{odil}.models.{model}")
    kw = {"device": "cpu"} if odil == "odil_torch" else {}
    if model == "poisson":
        return mod.build(dtype=np.float64, **POISSON, mesh=mesh, partition={"x": "x", "y": "y"} if mesh else None,
                         **kw)
    return mod.build(nt=16, nx=16, infer_k=True, imposed="random", nimp=20, kernel="pallas", dtype=np.float32,
                     mesh=mesh, partition={"t": "t"} if mesh else None, **kw)


def _stack_sharding(domain, mesh, batch_axis):
    """shape -> the port's sharding of a stacked array of ``shape``
    (instances first) where the domain's mesh spans processes."""
    from odil_torch import parallel

    def of(shape):
        shape = tuple(shape[1:])
        inner = list(domain.field_sharding(shape=shape).spec) if len(shape) == domain.ndim else [None] * len(shape)
        return parallel.NamedSharding(mesh, parallel.PartitionSpec(batch_axis, *inner))

    return of


# -- The worker ----------------------------------------------------------------


def _digest(tensors):
    return hashlib.sha256(b"".join(t.detach().contiguous().numpy().tobytes() for t in tensors)).hexdigest()


def _everyone(obj, world):
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def worker(rank, world, port, out):
    import torch

    torch.set_num_threads(1)
    from odil_torch import parallel, util
    from odil_torch.convert import arrays_from_numpy
    from odil_torch.models import poisson as tpo
    from odil_torch.newton import optimize_gauss_newton
    from odil_torch.optim import Adam
    from odil_torch.optim.base import autograd_loss_grad_fn

    parallel.init_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cpu", timeout=120)
    res = {}
    same = {}  # name -> whether every process has the same bits

    def evaluate(problem, state, arrays, fused):
        if fused:
            fn = problem.make_loss_grad_fn(state)
            assert fn is not None
        else:
            fn = autograd_loss_grad_fn(problem.make_loss_fn(state)[0])
        (loss, (terms, _)), grads = fn(arrays, problem.tracers)
        return loss.detach(), torch.stack([t.detach() for t in terms]), [g.detach() for g in grads]

    # The GSPMD route: each process's blocks of the loss's gradient, gathered
    # whole, against the single controller's whole gradient.
    cases = [(case, *_flagship(case, parallel.mesh_from_spec(spec))[:2], *_flagship(case, single=True)[:2], kernel,
              dtype) for case, (spec, _, kernel, dtype) in GSPMD.items()]
    cases += [(case, *_cross(case, parallel.mesh_from_spec("t:4" if case == "heat_t" else "t:2,x:2" if case
                                                            == "heat_tx" else "x:2,y:2"))[:2],
               *_cross(case)[:2], "xla", np.float64) for case in CROSS]
    for case, problem, state, single, sstate, kernel, dtype in cases:
        whole = arrays_from_numpy(_state_arrays(problem, state, dtype), device="cpu")
        shapes = [tuple(a.shape) for a in whole]
        mine = parallel.shard_state_arrays(problem.domain, whole)
        res[f"{case}/spans"] = np.array(problem.domain.mesh.spans_processes)
        res[f"{case}/blocks"] = np.array(any(tuple(m.shape) != s for m, s in zip(mine, shapes)))
        for fused in ((False, True) if kernel != "xla" else (False,)):
            loss, terms, grads = evaluate(problem, state, mine, fused)
            sloss, sterms, sgrads = evaluate(single, sstate, whole, fused)
            grads = parallel.gather_state_arrays(problem.domain, grads, shapes)
            key = f"{case}/{'fused' if fused else 'autograd'}"
            res[f"{key}/loss"], res[f"{key}/terms"] = loss.numpy(), terms.numpy()
            res[f"{key}/single_loss"], res[f"{key}/single_terms"] = sloss.numpy(), sterms.numpy()
            for i, (g, sg) in enumerate(zip(grads, sgrads)):
                res[f"{key}/grad{i}"], res[f"{key}/single_grad{i}"] = g.numpy(), sg.numpy()
        # eval_loss_grad: the harness's epoch-0 evaluation on the whole state.
        problem.domain.arrays_to_state(whole, state)
        loss, grads, terms, _, _ = problem.eval_loss_grad(state)
        res[f"{case}/eval_loss"] = np.asarray(loss)
        res[f"{case}/eval_grad"] = np.concatenate(
            [g.numpy().ravel() for g in parallel.gather_state_arrays(problem.domain, grads, shapes)])

    for case, spec in ADAM.items():
        dtype = GSPMD[case][3]
        problem, state, _ = _flagship(case, parallel.mesh_from_spec(spec))
        single, sstate, _ = _flagship(case, single=True)
        whole = arrays_from_numpy(_state_arrays(problem, state, dtype), device="cpu")
        fn = problem.make_loss_grad_fn(state) or autograd_loss_grad_fn(problem.make_loss_fn(state)[0])
        sfn = single.make_loss_grad_fn(sstate) or autograd_loss_grad_fn(single.make_loss_fn(sstate)[0])
        opt = Adam(fn, parallel.shard_state_arrays(problem.domain, whole), lr=ADAM_LR)
        res[f"adam_{case}/rows"] = opt.run_chunk(ADAM_EPOCHS).numpy()
        sopt = Adam(sfn, whole, lr=ADAM_LR)
        res[f"adam_{case}/single_rows"] = sopt.run_chunk(ADAM_EPOCHS).numpy()
        sh = [problem.domain.field_sharding(shape=s) for s in [tuple(a.shape) for a in whole]]
        held = [i for i, s in enumerate(sh) if len({s.region(tuple(whole[i].shape), r) for r in range(world)}) == 1]
        digests = _everyone([_digest([opt.x[i]]) for i in held], world)
        same[f"adam_{case}"] = all(d == digests[0] for d in digests)
        res[f"adam_{case}/held"] = np.array(held)
        x = parallel.gather_state_arrays(problem.domain, opt.x, [tuple(a.shape) for a in whole])
        res[f"adam_{case}/x"] = np.concatenate([a.numpy().ravel() for a in x])
        res[f"adam_{case}/single_x"] = np.concatenate([a.numpy().ravel() for a in sopt.x])

    # The training harness (util.optimize): Adam and GD on the GSPMD route;
    # the callback sees the whole state on every process.
    for optname in HARNESS:
        for who in ("spmd", "single"):
            problem, state, _ = _flagship("xla_x", parallel.mesh_from_spec(GSPMD["xla_x"][0]),
                                          single=who == "single")
            problem.domain.arrays_to_state(arrays_from_numpy(_state_arrays(problem, state, np.float64), "cpu"),
                                           state)
            rows, digests = [], []

            def callback(state, epoch, pinfo, problem=problem, rows=rows, digests=digests):
                rows.append(float(pinfo["loss"]))
                digests.append(_digest(problem.domain.arrays_from_state(state)))

            args = argparse.Namespace(epochs=HARNESS_EPOCHS, epoch_start=0, lr=1e-3, halo=0)
            util.optimize(args, optname, problem, state, callback)
            res[f"harness_{optname}/{who}"] = np.array(rows)
            res[f"harness_{optname}/{who}_x"] = problem.domain.pack_state(state).numpy()
            if who == "spmd":
                every = _everyone(digests, world)
                same[f"harness_{optname}"] = all(d == every[0] for d in every)

    # Gauss-Newton: rows, and a digest of every process's iterate at each
    # epoch.
    for case, (halo, linsolver, maxiter) in GN.items():
        for who in ("spmd", "single"):
            mesh = parallel.mesh_from_spec("x:2,y:2") if who == "spmd" else None
            problem, state, _ = tpo.build(dtype=np.float64, device="cpu", mesh=mesh,
                                          partition={"x": "x", "y": "y"} if mesh else None, **POISSON)
            rows, digests = [], []

            def callback(state, epoch, pinfo, problem=problem, rows=rows, digests=digests):
                rows.append([float(pinfo["loss"])] + [float(t) for t in pinfo["terms"]])
                digests.append(_digest([problem.domain.pack_state(state)]))

            args = _gn_args(halo if who == "spmd" else 0, linsolver, maxiter)
            optimize_gauss_newton(args, problem, state, callback)
            res[f"gn_{case}/{who}"] = np.array(rows)
            if who == "spmd":
                every = _everyone(digests, world)
                same[f"gn_{case}"] = all(d == every[0] for d in every)
                res[f"gn_{case}/x"] = problem.domain.pack_state(state).numpy()
            else:
                res[f"gn_{case}/single_x"] = problem.domain.pack_state(state).numpy()

    # multi_start: 4 starts on b:2, 2 a process.
    for name, scale in MS_SCALE.items():
        problem, state, _ = _ms_build(name, "odil_torch")
        rows = {}
        for who, mesh in (("spmd", parallel.mesh_from_spec("b:2")), ("single", None)):
            loss_b, stacked = parallel.multi_start(problem, state, STARTS, seed=1, scale=scale, mesh=mesh,
                                                   batch_axis="b" if mesh else None)
            fn = autograd_loss_grad_fn(loss_b)
            if who == "spmd":
                # The batched loss and gradient at the numpy-drawn starts
                # (this process's instances), for the JAX package's.
                starts = [torch.from_numpy(a[loss_b.instances]) for a in _ms_starts(problem, state)]
                (loss, (terms, _)), grads = fn(starts, problem.tracers)
                res[f"ms_{name}/np_loss"] = loss.detach().numpy()
                res[f"ms_{name}/np_terms"] = torch.stack([t.detach() for t in terms]).numpy()
                every = _everyone([g.numpy() for g in grads], world)
                for k in range(len(grads)):
                    res[f"ms_{name}/np_grad{k}"] = np.concatenate([g[k] for g in every])
            (loss, _), grads = fn(stacked, problem.tracers)
            opt = Adam(fn, stacked, lr=1e-3)
            losses = opt.run_chunk(STARTS_EPOCHS).numpy()
            loss_fn, _ = problem.make_loss_fn(state)
            with torch.no_grad():
                inst = [float(loss_fn([a[i] for a in opt.x], problem.tracers)[0]) for i in range(len(opt.x[0]))]
            rows[who] = (loss_b.form, list(loss_b.instances), float(loss), grads, losses, inst)
        form, mine, loss, grads, losses, inst = rows["spmd"]
        sform, _, sloss, sgrads, slosses, sinst = rows["single"]
        res[f"ms_{name}/form"] = np.array([form, sform])
        res[f"ms_{name}/loss"] = np.array([loss, sloss])
        res[f"ms_{name}/rows"] = np.array([losses, slosses])
        every = _everyone((mine, inst, [g.numpy() for g in grads]), world)
        res[f"ms_{name}/instances"] = np.array(sum((m for m, _, _ in every), []))
        res[f"ms_{name}/inst"] = np.array(sum((i for _, i, _ in every), []))
        res[f"ms_{name}/single_inst"] = np.array(sinst)
        for k, sg in enumerate(sgrads):
            res[f"ms_{name}/grad{k}"] = np.concatenate([g[k] for _, _, g in every])
            res[f"ms_{name}/single_grad{k}"] = sg.numpy()

    # The on-device L-BFGS through util.optimize: the rows and, after every
    # iteration, a digest of the whole state that each process's callback
    # sees.
    for case, (model, spec, halo) in LBFGS.items():
        for who in ("spmd", "single"):
            problem, state, _ = _lbfgs_build(model, parallel.mesh_from_spec(spec) if who == "spmd" else None)
            rows, digests = [], []

            def callback(state, epoch, pinfo, problem=problem, rows=rows, digests=digests):
                rows.append([float(pinfo["loss"])] + [float(t) for t in pinfo["terms"]])
                digests.append(_digest([problem.domain.pack_state(state)]))

            util.optimize(_lbfgs_args(halo if who == "spmd" else 0), "lbfgs", problem, state, callback)
            opt = problem._active_optimizer
            res[f"lbfgs_{case}/{who}"] = np.array(rows)
            res[f"lbfgs_{case}/{who}_x"] = problem.domain.pack_state(state).numpy()
            if who == "spmd":
                res[f"lbfgs_{case}/spans"] = np.array(problem.domain.mesh.spans_processes)
                res[f"lbfgs_{case}/evals"] = np.array([opt.evals, opt.grad_evals, opt.memory.s.numel()])
                every = _everyone(digests, world)
                same[f"lbfgs_{case}"] = all(d == every[0] for d in every) and len(every[0]) == LBFGS_ITERS + 1

    # multi_start on a domain mesh over the processes: the form, each
    # process's instances and blocks, the batch loss and every block of its
    # gradient against the single controller's, 5 Adam epochs, and the
    # batched loss and gradient at the numpy-drawn starts (for the JAX
    # package's).
    for case, (model, spec, owners, batch_axis) in MS_SPATIAL.items():
        scale = MS_SCALE[model]
        mesh = parallel.mesh_from_spec(spec)
        if owners is not None:
            mesh = parallel.Mesh(mesh.devices, mesh.axis_names, owners=owners)
        problem, state, _ = _ms_spatial_build(model, "odil_torch", mesh)
        single, sstate, _ = _ms_spatial_build(model, "odil_torch")
        loss_b, stacked = parallel.multi_start(problem, state, STARTS, seed=1, scale=scale,
                                               mesh=mesh if batch_axis else None, batch_axis=batch_axis)
        sloss_b, sstacked = parallel.multi_start(single, sstate, STARTS, seed=1, scale=scale)
        fn, sfn = autograd_loss_grad_fn(loss_b), autograd_loss_grad_fn(sloss_b)
        sharding = _stack_sharding(problem.domain, mesh, batch_axis)
        (loss, (terms, _)), grads = fn(stacked, problem.tracers)
        (sloss, (sterms, _)), sgrads = sfn(sstacked, single.tracers)
        blocks = [sharding(tuple(sg.shape)).place(sg) for sg in sgrads]
        key = f"msx_{case}"
        res[f"{key}/form"] = np.array([loss_b.form, sloss_b.form])
        res[f"{key}/instances"] = np.array(sum(_everyone(list(loss_b.instances), world), []))
        res[f"{key}/loss"] = np.array([float(loss), float(sloss)])
        res[f"{key}/terms"] = np.array([[float(t) for t in terms], [float(t) for t in sterms]])
        res[f"{key}/stacked"] = np.array(_everyone(all(torch.equal(a, sharding(tuple(b.shape)).place(b))
                                                       for a, b in zip(stacked, sstacked)), world))
        res[f"{key}/grad_bits"] = np.array(_everyone(all(torch.equal(g, b) for g, b in zip(grads, blocks)), world))
        opt, sopt = Adam(fn, stacked, lr=1e-3), Adam(sfn, sstacked, lr=1e-3)
        res[f"{key}/rows"] = np.array([opt.run_chunk(STARTS_EPOCHS).numpy(), sopt.run_chunk(STARTS_EPOCHS).numpy()])
        starts = _ms_starts(single, sstate)
        (loss, (terms, _)), grads = fn([sharding(a.shape).place(torch.from_numpy(a)) for a in starts],
                                       problem.tracers)
        res[f"{key}/np_loss"] = loss.detach().numpy()
        res[f"{key}/np_terms"] = torch.stack([t.detach() for t in terms]).numpy()
        parts = _everyone([g.numpy() for g in grads], world)
        for k, a in enumerate(starts):
            whole = np.zeros(a.shape, dtype=a.dtype)
            for r in range(world):
                whole[tuple(slice(lo, hi) for lo, hi in sharding(a.shape).region(a.shape, r))] = parts[r][k]
            res[f"{key}/np_grad{k}"] = whole

    # --halo on a mesh with an idle axis: the plain flagship's loss, terms
    # and gathered gradient, and those of one process's mesh t:2.
    from odil_torch.models import veltracer

    for spec in IDLE:
        got = {}
        for who in ("spmd", "one"):
            mesh = parallel.mesh_from_spec(spec) if who == "spmd" else parallel.Mesh(
                np.array([torch.device("cpu")] * 2, dtype=object), ("t",), owners=[rank, rank], process=rank)
            problem, state, _ = veltracer.build(kernel="xla", dtype=np.float64, device="cpu", mesh=mesh,
                                                partition={"t": "t"}, **FLAGSHIP)
            whole = arrays_from_numpy(_state_arrays(problem, state, np.float64), device="cpu")
            shapes = [tuple(a.shape) for a in whole]
            fn = autograd_loss_grad_fn(problem.make_loss_fn(state, halo=True)[0])
            (loss, (terms, _)), grads = fn(parallel.shard_state_arrays(problem.domain, whole), problem.tracers)
            grads = parallel.gather_state_arrays(problem.domain, grads, shapes)
            got[who] = (loss.detach().numpy(), torch.stack([t.detach() for t in terms]).numpy(),
                        np.concatenate([g.numpy().ravel() for g in grads]))
        res[f"idle_{spec}/spans"] = np.array(parallel.mesh_from_spec(spec).spans_processes)
        for who, (loss, terms, grad) in got.items():
            res[f"idle_{spec}/{who}_loss"], res[f"idle_{spec}/{who}_terms"] = loss, terms
            res[f"idle_{spec}/{who}_grad"] = grad

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "odil_tpu", "odil")]
    res["jax_modules"] = np.array([len(m) for m in _everyone(loaded, world)])
    agreed = _everyone(same, world)
    res["same_bits"] = np.array(sorted(k for k in same if all(a[k] for a in agreed)))
    res["checked_bits"] = np.array(sorted(same))
    if rank == 0:
        np.savez(out, **res)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank} done", flush=True)


# -- The test ------------------------------------------------------------------


def _jax_refs():
    """The JAX package's unsharded loss and gradient of the plain flagship
    at the cases' state and of the ``pallas_mg`` one (its fused route and
    autograd of its loss, the kernels in interpret mode), its Gauss-Newton
    rows through its halo residual map on x:2,y:2 (4 virtual CPU devices),
    plain CG, and its ``multi_start`` batched loss and gradient on b:2 (2
    virtual CPU devices) at the numpy-drawn starts."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from odil_tpu import parallel as jpar
    from odil_tpu import util as jutil
    from odil_tpu.halo import make_halo_loss_fn
    from odil_tpu.models import poisson as jpo
    from odil_tpu.models import veltracer as jvt
    from odil_tpu.newton import optimize_gauss_newton

    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jp, js, _ = jvt.build(kernel="xla", dtype=np.float64, **FLAGSHIP)
        arrays = [jnp.asarray(a) for a in _state_arrays(jp, js, np.float64)]
        loss_fn, _ = jp.make_loss_fn(js)
        (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(arrays, jp.tracers)
        refs = {"xla": (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])}
        jp, js, _ = jvt.build(kernel="pallas_mg", dtype=np.float32, **FLAGSHIP)
        arrays = [jnp.asarray(a) for a in _state_arrays(jp, js, np.float32)]
        (loss, (terms, _)), grads = jax.jit(jp.make_loss_grad_fn(js))(arrays, jp.tracers)
        refs["pallas_mg/fused"] = (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])
        loss_fn, _ = jp.make_loss_fn(js)
        (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(arrays, jp.tracers)
        refs["pallas_mg/autograd"] = (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])
        bmesh = jpar.mesh_from_spec("b:2", devices=jax.devices()[:2])
        for name, scale in MS_SCALE.items():
            jp, js, _ = _ms_build(name, "odil_tpu")
            loss_b, _ = jpar.multi_start(jp, js, STARTS, seed=1, scale=scale, mesh=bmesh, batch_axis="b")
            starts = [jax.device_put(jnp.asarray(a), NamedSharding(bmesh, PartitionSpec("b")))
                      for a in _ms_starts(jp, js)]
            (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_b, has_aux=True))(starts, jp.tracers)
            refs[f"ms_{name}"] = (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])
        mesh = jpar.mesh_from_spec("x:2,y:2", devices=jax.devices()[:4])
        problem, state, _ = jpo.build(dtype=np.float64, mesh=mesh, partition={"x": "x", "y": "y"}, **POISSON)
        rows = []

        def callback(state, epoch, pinfo):
            rows.append([float(pinfo["loss"])] + [float(t) for t in pinfo["terms"]])

        halo, linsolver, maxiter = GN["halo_cg"]
        optimize_gauss_newton(_gn_args(halo, linsolver, maxiter), problem, state, callback)
        refs["gn"] = np.array(rows)
        # The L-BFGS through util.optimize: poisson on x:2,y:2.
        problem, state, _ = jpo.build(dtype=np.float64, mesh=mesh, partition={"x": "x", "y": "y"}, **POISSON)
        rows = []
        jutil.optimize(_lbfgs_args(0), "lbfgs", problem, state, callback)
        refs["lbfgs_poisson"] = np.array(rows)
        # multi_start on a domain mesh, at the numpy-drawn starts.
        for case, (model, spec, _, batch_axis) in MS_SPATIAL.items():
            jmesh = jpar.mesh_from_spec(spec, devices=jax.devices()[:4])
            jp, js, _ = _ms_spatial_build(model, "odil_tpu", jmesh)
            loss_b, _ = jpar.multi_start(jp, js, STARTS, seed=1, scale=MS_SCALE[model],
                                         mesh=jmesh if batch_axis else None, batch_axis=batch_axis)
            starts = [jnp.asarray(a) for a in _ms_starts(jp, js)]
            if batch_axis:
                starts = [jax.device_put(a, NamedSharding(jmesh, PartitionSpec(batch_axis))) for a in starts]
            (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_b, has_aux=True))(starts, jp.tracers)
            refs[f"msx_{case}"] = (float(loss), [float(t) for t in terms], [np.asarray(g) for g in grads])
        # --halo on t:2,q:2 (q partitions no grid dimension).
        jmesh = jpar.mesh_from_spec("t:2,q:2", devices=jax.devices()[:4])
        jp, js, _ = jvt.build(kernel="xla", dtype=np.float64, mesh=jmesh, partition={"t": "t"}, **FLAGSHIP)
        arrays = [jnp.asarray(a) for a in _state_arrays(jp, js, np.float64)]
        loss_fn, _ = make_halo_loss_fn(jp, js)
        (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(arrays, jp.tracers)
        refs["idle"] = (float(loss), [float(t) for t in terms], np.concatenate([np.asarray(g).ravel() for g in grads]))
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    return refs


if __name__ != "__main__":
    import pytest

    @pytest.fixture(scope="module")
    def results(tmp_path_factory):
        """Two runs of the workers (the second for the determinism check),
        started together; the JAX package's numbers computed while they
        run."""
        from test_torch_distributed import _launch

        d = tmp_path_factory.mktemp("dist_routes")
        waits = [_launch(str(d / f"run{n}.npz"), script=os.path.abspath(__file__)) for n in range(2)]
        refs = _jax_refs()
        return [w() for w in waits], refs

    @pytest.fixture(scope="module")
    def run(results):
        return results[0][0]

    def _grads(run, key, single=False):
        n = len([k for k in run if k.startswith(f"{key}/grad")])
        return [run[f"{key}/{'single_' if single else ''}grad{i}"] for i in range(n)]

    def _close(got, want, rtol, atol_frac):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max())))

    def test_gspmd_plain_matches_jax(run, results):
        """The plain flagship (16^3 fp64) on t:2,x:4 over 2 processes: loss,
        terms and gradient within 1e-12 of the JAX package's unsharded
        make_loss_fn (dcn_worker.py's GSPMD check)."""
        loss, terms, grads = results[1]["xla"]
        assert run["xla/spans"]
        np.testing.assert_allclose(float(run["xla/autograd/loss"]), loss, rtol=1e-12)
        np.testing.assert_allclose(run["xla/autograd/terms"], terms, rtol=1e-12)
        got = _grads(run, "xla/autograd")
        assert len(got) == len(grads)
        for a, b in zip(got, grads):
            _close(a, b, 1e-12, 1e-12)
        np.testing.assert_allclose(run["xla/eval_grad"], np.concatenate([g.ravel() for g in got]), rtol=0,
                                   atol=1e-13 * max(1.0, max(float(np.abs(b).max()) for b in grads)))

    @pytest.mark.parametrize("key", ["pallas_mg/autograd", "pallas_mg/fused"])
    def test_gspmd_pallas_mg_matches_jax(run, results, key):
        """The flagship's pallas_mg route (16^3 fp32) on t:2,x:4 over 2
        processes, through autograd of make_loss_fn and the fused
        make_loss_grad_fn: loss and terms within rtol 1e-5, the gradient
        within rtol 1e-4 (atol 1e-6 of its largest entry) of the JAX
        package's unsharded evaluation of the same route, its kernels in
        interpret mode."""
        loss, terms, grads = results[1][key]
        assert run["pallas_mg/spans"] and run["pallas_mg/blocks"]
        np.testing.assert_allclose(float(run[f"{key}/loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(run[f"{key}/terms"], terms, rtol=1e-5)
        got = _grads(run, key)
        assert len(got) == len(grads) > 0
        for a, b in zip(got, grads):
            assert a.shape == b.shape
            _close(a, b, 1e-4, 1e-6)

    @pytest.mark.parametrize("key", ["xla/autograd", "xla_x/autograd", "idle/autograd", "pallas/autograd",
                                     "pallas/fused",
                                     "pallas_mg/autograd", "pallas_mg/fused"]
                             + [f"{case}/autograd" for case in CROSS])
    def test_gspmd_is_the_single_controller(run, key):
        """Every GSPMD case over 2 processes (the plain flagship, a mesh axis
        that partitions nothing, the kernel routes, the operators that read
        across blocks), each process holding its blocks or, where the
        partition replicates, the whole arrays: the loss, terms and the
        gathered gradient equal the single controller's to the bit, not
        twice it; so do eval_loss_grad's."""
        case = key.split("/")[0]
        assert run[f"{case}/spans"] and run[f"{case}/blocks"] != (case in WHOLE)
        assert run[f"{key}/loss"].tobytes() == run[f"{key}/single_loss"].tobytes()
        assert run[f"{key}/terms"].tobytes() == run[f"{key}/single_terms"].tobytes()
        grads, sgrads = _grads(run, key), _grads(run, key, single=True)
        assert len(grads) == len(sgrads) > 0
        for a, b in zip(grads, sgrads):
            assert a.tobytes() == b.tobytes(), (float(np.abs(a).max()), float(np.abs(b).max()))
        eval_grad = np.concatenate([g.ravel() for g in _grads(run, f"{case}/autograd", single=True)])
        assert run[f"{case}/eval_grad"].tobytes() == eval_grad.tobytes()
        assert run[f"{case}/eval_loss"].tobytes() == run[f"{case}/autograd/single_loss"].tobytes()

    @pytest.mark.parametrize("case", list(ADAM))
    def test_adam_over_processes(run, case):
        """20 Adam epochs on the GSPMD route over 2 processes: on blocks
        (fp64 plain flagship) rows and the final arrays within rtol 1e-10 of
        the single controller's; on whole arrays (fp32 pallas_mg) equal to
        its to the bit; and every array that both processes hold whole with
        the same bits on both.  Not the bits on blocks: the gradient is the
        single controller's (the tests above), but on the CPU an elementwise
        update of a block of another length meets other vectorized loops
        and scalar tails."""
        rows, srows = run[f"adam_{case}/rows"], run[f"adam_{case}/single_rows"]
        x, sx = run[f"adam_{case}/x"], run[f"adam_{case}/single_x"]
        if case == "pallas_mg":
            assert rows.tobytes() == srows.tobytes() and x.tobytes() == sx.tobytes()
            assert len(run[f"adam_{case}/held"]) > 0
        np.testing.assert_allclose(rows, srows, rtol=1e-10)
        np.testing.assert_allclose(x, sx, rtol=1e-10, atol=1e-12 * max(1.0, float(np.abs(sx).max())))
        assert f"adam_{case}" in run["same_bits"]

    @pytest.mark.parametrize("optname", HARNESS)
    def test_harness_over_processes(run, optname):
        """util.optimize over 2 processes (the GSPMD route): the callback's
        rows and the final state within rtol 1e-10 of the single
        controller's (as Adam above), and the whole state that every
        process's callback sees with the same bits on both at every epoch."""
        rows, srows = run[f"harness_{optname}/spmd"], run[f"harness_{optname}/single"]
        assert len(rows) == HARNESS_EPOCHS + 1
        np.testing.assert_allclose(rows, srows, rtol=1e-10)
        x, sx = run[f"harness_{optname}/spmd_x"], run[f"harness_{optname}/single_x"]
        np.testing.assert_allclose(x, sx, rtol=1e-10, atol=1e-12 * max(1.0, float(np.abs(sx).max())))
        assert f"harness_{optname}" in run["same_bits"]

    def test_gauss_newton_halo_matches_jax(run, results):
        """Plain-CG Gauss-Newton under --halo on x:2,y:2 over 2 processes:
        the rows within 1e-9 of the JAX package's halo residual map with its
        optimize_gauss_newton."""
        np.testing.assert_allclose(run["gn_halo_cg/spmd"], results[1]["gn"], rtol=1e-9, atol=1e-14)

    @pytest.mark.parametrize("case", list(GN))
    def test_gauss_newton_over_processes(run, case):
        """Every Gauss-Newton case over 2 processes: rows and the iterate
        within 1e-9 of the single controller's, and every process's iterate
        with the same bits at each epoch."""
        np.testing.assert_allclose(run[f"gn_{case}/spmd"], run[f"gn_{case}/single"], rtol=1e-9, atol=1e-14)
        x, sx = run[f"gn_{case}/x"], run[f"gn_{case}/single_x"]
        np.testing.assert_allclose(x, sx, rtol=0, atol=1e-9 * max(1.0, float(np.abs(sx).max())))
        assert f"gn_{case}" in run["same_bits"]

    @pytest.mark.parametrize("name", ["poisson", "heat"])
    def test_multi_start_over_processes(run, name):
        """4 starts on the batch axis over 2 processes: the form of the
        single controller, each process its block of instances, the batch
        mean, every instance's gradient, the Adam rows and every instance's
        loss after them against the single controller's (fp64 vmap: 1e-12;
        fp32 kernel loop: to the bit)."""
        form, sform = run[f"ms_{name}/form"]
        assert form == sform == ("vmap" if name == "poisson" else "loop")
        assert list(run[f"ms_{name}/instances"]) == list(range(STARTS))
        rtol = 1e-12 if name == "poisson" else 0.0
        np.testing.assert_allclose(*run[f"ms_{name}/loss"], rtol=rtol)
        np.testing.assert_allclose(*run[f"ms_{name}/rows"], rtol=rtol)
        np.testing.assert_allclose(run[f"ms_{name}/inst"], run[f"ms_{name}/single_inst"], rtol=rtol)
        grads, sgrads = _grads(run, f"ms_{name}"), _grads(run, f"ms_{name}", single=True)
        assert len(grads) == len(sgrads) > 0
        for a, b in zip(grads, sgrads):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1.0, float(np.abs(b).max())))

    @pytest.mark.parametrize("name", ["poisson", "heat"])
    def test_multi_start_matches_jax(run, results, name):
        """The batched loss, terms and gradient of multi_start with the batch
        axis over 2 processes, at numpy-drawn starts, against the JAX
        package's multi_start on a b:2 mesh of virtual CPU devices: fp64
        (poisson, vmap) within 1e-12; fp32 (heat, the kernel loop against
        the JAX package's vmap of its pallas kernels in interpret mode)
        loss and terms within rtol 1e-5, the gradient within rtol 1e-4
        (atol 1e-6 of its largest entry)."""
        loss, terms, grads = results[1][f"ms_{name}"]
        rtol, grtol, gatol = (1e-12, 1e-12, 1e-12) if name == "poisson" else (1e-5, 1e-4, 1e-6)
        np.testing.assert_allclose(float(run[f"ms_{name}/np_loss"]), loss, rtol=rtol)
        np.testing.assert_allclose(run[f"ms_{name}/np_terms"], terms, rtol=rtol, atol=1e-30)
        got = [run[f"ms_{name}/np_grad{k}"] for k in range(len(grads))]
        assert f"ms_{name}/np_grad{len(grads)}" not in run
        for a, b in zip(got, grads):
            assert a.shape == b.shape
            _close(a, b, grtol, gatol)

    @pytest.mark.parametrize("case", list(LBFGS))
    def test_lbfgs_over_processes(run, case):
        """util.optimize with the on-device L-BFGS over 2 processes, 8
        iterations (poisson 16^2 fp64, the plain flagship 16^3 fp64 and the
        pallas_mg flagship 8x16x16 fp32 on the GSPMD route; wave 16^2 fp64
        under --halo on t:2): the rows equal to the single controller's to
        the bit on the GSPMD route and within rtol 1e-10 under --halo, the
        final state likewise, and the whole state with the same bits on
        both processes after every iteration."""
        rows, srows = run[f"lbfgs_{case}/spmd"], run[f"lbfgs_{case}/single"]
        x, sx = run[f"lbfgs_{case}/spmd_x"], run[f"lbfgs_{case}/single_x"]
        assert run[f"lbfgs_{case}/spans"] and rows.shape == srows.shape and len(rows) == LBFGS_ITERS + 1
        evals, grad_evals, _ = run[f"lbfgs_{case}/evals"]
        assert evals == LBFGS_ITERS and grad_evals >= 2 * LBFGS_ITERS
        if LBFGS[case][2]:
            np.testing.assert_allclose(rows, srows, rtol=1e-10, atol=0)
            np.testing.assert_allclose(x, sx, rtol=1e-10, atol=1e-12 * max(1.0, float(np.abs(sx).max())))
        else:
            assert rows.tobytes() == srows.tobytes() and x.tobytes() == sx.tobytes()
        assert f"lbfgs_{case}" in run["same_bits"]

    def test_lbfgs_poisson_matches_jax(run, results):
        """The L-BFGS rows of poisson 16^2 fp64 on x:2,y:2 over 2 processes
        against the JAX package's LbfgsOptimizer (util.optimize) on a mesh of
        4 virtual CPU devices, within tests/test_torch_lbfgs.py's rtol 1e-10."""
        np.testing.assert_allclose(run["lbfgs_poisson/spmd"], results[1]["lbfgs_poisson"], rtol=1e-10, atol=1e-14)

    @pytest.mark.parametrize("case", list(MS_SPATIAL))
    def test_multi_start_on_a_spanning_domain_mesh(run, case):
        """multi_start with 4 starts on a domain mesh over 2 processes: (a)
        poisson 16^2 fp64 on x:2,y:2, every instance on each process's
        blocks; (b) heat 16^2 pallas fp32 on b:2,t:2 (the domain's t on t, the
        instances on b), a process a b index or a t index.  The single
        controller's form; each process's stacked starts the blocks of the
        single controller's; the batch loss and terms equal to its to the bit
        and every block of the gradient too; 5 Adam epochs within rtol 1e-10
        (fp64) or 1e-5 (fp32)."""
        key = f"msx_{case}"
        form, sform = run[f"{key}/form"]
        assert form == sform == ("vmap" if case == "a" else "loop")
        want = list(range(STARTS)) * (1 if case == "b_b" else 2)
        assert list(run[f"{key}/instances"]) == want
        assert all(run[f"{key}/stacked"]) and all(run[f"{key}/grad_bits"])
        loss, terms = run[f"{key}/loss"], run[f"{key}/terms"]
        assert loss[0].tobytes() == loss[1].tobytes() and terms[0].tobytes() == terms[1].tobytes()
        rows = run[f"{key}/rows"]
        np.testing.assert_allclose(rows[0], rows[1], rtol=1e-10 if case == "a" else 1e-5)

    @pytest.mark.parametrize("case", list(MS_SPATIAL))
    def test_multi_start_on_a_spanning_domain_mesh_matches_jax(run, results, case):
        """The batched loss, terms and gradient of each spanning-mesh form at
        numpy-drawn starts against the JAX package's multi_start on the same
        mesh of virtual CPU devices: fp64 within 1e-12; fp32 (the kernel
        loop against its pallas kernels in interpret mode) loss and terms
        within rtol 1e-5, the gradient within rtol 1e-4 (atol 1e-6 of its
        largest entry)."""
        loss, terms, grads = results[1][f"msx_{case}"]
        key = f"msx_{case}"
        rtol, grtol, gatol = (1e-12, 1e-12, 1e-12) if case == "a" else (1e-5, 1e-4, 1e-6)
        np.testing.assert_allclose(float(run[f"{key}/np_loss"]), loss, rtol=rtol)
        np.testing.assert_allclose(run[f"{key}/np_terms"], terms, rtol=rtol, atol=1e-30)
        assert f"{key}/np_grad{len(grads)}" not in run
        for k, b in enumerate(grads):
            a = run[f"{key}/np_grad{k}"]
            assert a.shape == b.shape
            _close(a, b, grtol, gatol)

    @pytest.mark.parametrize("spec", IDLE)
    def test_halo_idle_axis_over_processes(run, results, spec):
        """--halo over 2 processes on a mesh whose axis q partitions no grid
        dimension (t:2,q:2: each process a t index; q:2,t:2: the processes
        replicas of each other): the plain flagship's loss, terms and
        gathered gradient within 1e-12 of the JAX package's
        make_halo_loss_fn on t:2,q:2 of virtual CPU devices, and equal to
        the port's one-process mesh t:2 to the bit (each shard's sums once,
        the replicas' gradients not summed)."""
        loss, terms, grad = results[1]["idle"]
        key = f"idle_{spec}"
        assert run[f"{key}/spans"]
        np.testing.assert_allclose(float(run[f"{key}/spmd_loss"]), loss, rtol=1e-12)
        np.testing.assert_allclose(run[f"{key}/spmd_terms"], terms, rtol=1e-12)
        _close(run[f"{key}/spmd_grad"], grad, 1e-12, 1e-12)
        for what in ("loss", "terms", "grad"):
            assert run[f"{key}/spmd_{what}"].tobytes() == run[f"{key}/one_{what}"].tobytes(), what

    def test_every_process_same_bits(run):
        """Every check of bits across processes ran and held."""
        assert list(run["same_bits"]) == list(run["checked_bits"]) and len(run["checked_bits"]) == 8 + len(LBFGS)

    def test_workers_import_no_jax(run):
        """No worker process loaded jax or the JAX package."""
        assert list(run["jax_modules"]) == [0] * NPROC

    # -- In one process: the refusals that stay, on meshes that span
    # processes without a group (a collective would raise another error
    # there).

    def _spanning(spec, process=0):
        import torch

        from odil_torch import parallel

        m = parallel.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
        owners = np.repeat(np.arange(NPROC), m.devices.size // NPROC).reshape(m.devices.shape)
        return parallel.Mesh(m.devices, m.axis_names, owners=owners, process=process)

    def _poisson(mesh):
        from odil_torch.models import poisson as tpo

        return tpo.build(dtype=np.float64, device="cpu", mesh=mesh, partition={"x": "x", "y": "y"}, **POISSON)

    def _raises_naming(call, *names):
        with pytest.raises(NotImplementedError) as info:
            call()
        text = str(info.value)
        assert "several processes" in text and all(n in text for n in names), text

    @pytest.mark.parametrize("optimizer", ["lbfgs", "lbfgsb"])
    def test_lbfgs_refused_over_processes(optimizer):
        """L-BFGS-B over processes raises before any collective, naming the
        optimizers to use instead; the on-device L-BFGS is no longer refused
        (it runs over processes: test_lbfgs_over_processes)."""
        from odil_torch import util

        problem, state, _ = _poisson(_spanning("x:2,y:2"))
        args = argparse.Namespace(epochs=2, epoch_start=0, lr=1e-3, halo=0)
        if optimizer == "lbfgs":
            assert util.refuse_over_processes(problem.domain, optimizer) is None
            return
        _raises_naming(lambda: util.optimize(args, optimizer, problem, state), "--optimizer adam or gd", "gn")

    def test_newton_refused_over_processes():
        """The sparse Newton and its linearization over processes raise
        before any collective, naming the matrix-free Gauss-Newton."""
        from odil_torch import util

        problem, state, _ = _poisson(_spanning("x:2,y:2", process=1))
        args = argparse.Namespace(epochs=2, epoch_start=0, linsolver="direct")
        _raises_naming(lambda: util.optimize(args, "newton", problem, state), "--optimizer gn")
        _raises_naming(lambda: problem.linearize(state), "Gauss-Newton")

    def test_multi_start_refuses_a_spatial_mesh_over_processes():
        """multi_start on a problem whose domain mesh spans processes builds
        without a collective: every instance on this process's domain
        blocks, or with a batch axis of the domain's mesh its block of the
        instances too; a batch axis of another mesh, or one that partitions
        a grid dimension, is refused before any collective."""
        from odil_torch import parallel

        problem, state, _ = _poisson(_spanning("x:2,y:2"))
        loss_b, stacked = parallel.multi_start(problem, state, 4)
        blocks = parallel.shard_state_arrays(problem.domain, problem.domain.arrays_from_state(state))
        assert loss_b.instances == [0, 1, 2, 3] and loss_b.form == "vmap"
        assert [tuple(a.shape) for a in stacked] == [(4,) + tuple(b.shape) for b in blocks]
        with pytest.raises(ValueError, match="partitions no grid dimension"):
            parallel.multi_start(problem, state, 4, mesh=problem.domain.mesh, batch_axis="x")
        with pytest.raises(ValueError, match="domain's own mesh"):
            parallel.multi_start(problem, state, 4, mesh=_spanning("x:2,y:2"), batch_axis="x")
        mesh = _spanning("b:2,x:2,y:2", process=1)
        problem, state, _ = _poisson(mesh)
        loss_b, stacked = parallel.multi_start(problem, state, 4, mesh=mesh, batch_axis="b")
        assert loss_b.instances == [2, 3] and [tuple(a.shape) for a in stacked] == [(2, 16, 16)]

    def test_two_runs_same_bits(results):
        """A second launch repeats every number of the first to the bit."""
        first, again = results[0]
        assert sorted(first) == sorted(again)
        differ = [k for k in first if first[k].tobytes() != again[k].tobytes()]
        assert not differ, differ


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
