"""The port's training harness against the JAX package on the CPU.

- ``history``, ``io``, ``cache`` and ``checkpoint``: the cases of
  tests/test_io.py run through both packages; the files they write are
  byte-identical, the values read back equal.
- Pickle checkpoints load across the two packages (exact).
- An Adam run resumed from a checkpoint with its slots reproduces the rows
  of the uninterrupted run to the bit.
- ``compute_task_epochs``, ``plan_chunks`` and ``Optimizer._emit`` equal the
  JAX package's; the optimizers that are not ported raise.
- End to end, fp64: the port's veltracer CLI (``--kernel xla``, ``pallas``
  and ``pallas_mg``, the kernels' plain versions) against the JAX package's
  example in a subprocess at 16^3, Adam, 30 epochs: every ``train.csv`` row's
  epoch, frame, norm_* and loss within rtol 1e-7.  The wave CLI at 32^2 with
  L-BFGS-B, 20 epochs: loss and error_u within rtol 1e-7 while the two
  trajectories are still determined by their inputs (epochs 0-12; measured
  agreement 1e-14), and from there no farther apart than 10 times the
  port's own distance from a run whose gradients carry one-ulp noise.
  L-BFGS-B amplifies a one-ulp difference about 100 times an iteration from
  epoch 11 on at this size (a 0.4% spread of the loss by epoch 20 between
  two runs of the port alone), so no second implementation can hold 1e-7
  there.  Run with ``-s`` to see the distances.
"""

import argparse
import csv
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import odil_torch as todil
from odil_torch import util as tutil
from odil_torch.optim import base as tbase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-7


@pytest.fixture
def outdir(tmp_path, monkeypatch):
    """A working directory for a CLI run; the cwd and both log sinks are
    restored afterwards (setup_outdir chdirs and opens train.log)."""
    import odil_tpu.util as jutil

    monkeypatch.chdir(tmp_path)
    saved = [(u._log_sink, u._log_sink.stream, u._log_sink.echo) for u in (tutil, jutil)]
    yield tmp_path
    for sink, stream, echo in saved:
        if sink.stream is not stream:
            sink.stream.close()
        sink.stream, sink.echo = stream, echo


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


# -- history, io, cache, checkpoint -------------------------------------------


def _history_case(odil, d):
    h = odil.History(csvpath=os.path.join(d, "h.csv"), warmup=1)
    h.append("epoch", 0)
    h.append("loss", 1.0)
    h.write()
    h.append("epoch", 1)
    h.append("loss", 0.5)
    h.append("extra", 3.0)  # a late column joins during the warm-up
    h.write()
    h.append("epoch", 2)
    h.append("loss", np.asarray(0.25))
    h.append("extra", np.float32(4.0))
    h.write()
    h.save(os.path.join(d, "h.pickle"))
    h2 = odil.History()
    h2.load(os.path.join(d, "h.pickle"))
    h.close()
    return {"data": h2.data, "epoch": h2.get("epoch")}


def _raw_case(dtype, shape):
    def run(odil, d):
        u = np.arange(np.prod(shape), dtype=dtype).reshape(shape) / 7
        path = os.path.join(d, "field.xdmf2")
        odil.write_raw_with_xmf(u, path, spacing=(0.5, 1.0, 2.0)[: len(shape)], name="phi", cell=True)
        back, meta = odil.read_raw_with_xmf(path)
        return {"back": back, "meta": dict(meta, rawpath=os.path.basename(meta["rawpath"]))}

    return run


def _vtk_case(binary):
    def run(odil, d):
        points = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=float)
        odil.write_vtk_poly(
            os.path.join(d, "poly.vtk"), points, polygons=[[0, 1, 2]], lines=[[0, 1]],
            point_fields={"val": np.array([1.0, 2.0, 3.0])}, cell_fields={"cid": np.array([7.0])},
            tcoords=np.zeros((3, 2)), binary=binary,
        )
        return {}

    return run


def _cache_case(odil, d):
    calls = []
    out = []
    for ext in (".pickle", ".json", ".npy"):

        @odil.cache.cache_to_file(os.path.join(d, "c" + ext), arg0_key=True)
        def slow(x):
            calls.append(x)
            return [x * 2, x]

        out += [slow(3), slow(3), slow(4)]
    return {"calls": calls, "out": [np.asarray(v).tolist() for v in out]}


IO_CASES = {
    "raw_xmf_f32": _raw_case(np.float32, (2, 3, 4)),
    "raw_xmf_f64": _raw_case(np.float64, (2, 3, 4)),
    "raw_xmf_2d": _raw_case(np.float64, (3, 4)),
    "vtk_ascii": _vtk_case(False),
    "vtk_binary": _vtk_case(True),
    "history_csv": _history_case,
    "cache_to_file": _cache_case,
}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert type(a) is type(b) or isinstance(a, np.ndarray)


@pytest.mark.parametrize("case", list(IO_CASES))
def test_io_cases_match_the_jax_package(case, tmp_path):
    """The same calls through both packages: files byte-identical, results
    equal (exact)."""
    import odil_tpu as jodil

    results, files = {}, {}
    for name, odil in (("jax", jodil), ("torch", todil)):
        d = tmp_path / name
        d.mkdir()
        results[name] = IO_CASES[case](odil, str(d))
        files[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files["torch"].keys() == files["jax"].keys() and files["jax"]
    for key in files["jax"]:
        assert files["torch"][key] == files["jax"][key], key
    _equal(results["torch"], results["jax"])
    if case == "history_csv":
        lines = files["torch"]["h.csv"].decode().strip().split("\n")
        assert lines[0] == "epoch,loss,extra" and len(lines) == 4


def _jax_state(seed):
    import odil_tpu as jodil

    domain = jodil.Domain(cshape=(4, 4), dimnames=["x", "y"], multigrid=True, mg_convert_all=False,
                          dtype=np.float64)
    rng = np.random.default_rng(seed)
    domain.mod.random.set_seed(seed)
    net = domain.make_neural_net([2, 3, 1])
    net.weights = [rng.normal(size=w.shape) for w in net.weights]
    net.biases = [rng.normal(size=b.shape) for b in net.biases]
    fields = {"u": rng.normal(size=(4, 4)), "mg": domain.regular_to_multigrid(rng.normal(size=(4, 4))), "net": net,
              "a": [1.0, 2.0]}
    return domain, domain.init_state(jodil.State(fields=fields))


def _torch_state(seed):
    domain = todil.Domain(cshape=(4, 4), dimnames=["x", "y"], multigrid=True, mg_convert_all=False,
                          dtype=np.float64, device="cpu")
    rng = np.random.default_rng(seed)
    net = domain.make_neural_net([2, 3, 1], torch.Generator().manual_seed(seed))
    net.weights = [domain.cast(rng.normal(size=tuple(w.shape))) for w in net.weights]
    net.biases = [domain.cast(rng.normal(size=tuple(b.shape))) for b in net.biases]
    fields = {"u": rng.normal(size=(4, 4)), "mg": domain.regular_to_multigrid(rng.normal(size=(4, 4))), "net": net,
              "a": [1.0, 2.0]}
    return domain, domain.init_state(todil.State(fields=fields))


def _packed(domain, state):
    p = domain.pack_state(state)
    return p.numpy() if torch.is_tensor(p) else np.asarray(p)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_across_packages(writer, tmp_path):
    """A pickle checkpoint written by one package loads into the other's
    state (every field kind; exact), with its optimizer slots, and a state
    saved and loaded by the same package is unchanged."""
    import odil_tpu.checkpoint as jck

    from odil_torch import checkpoint as tck

    path = str(tmp_path / "ck.pickle")
    slots = {"m": [np.arange(3.0)], "v": [np.ones(3)], "step": np.asarray(7)}
    src_domain, src_state = (_jax_state if writer == "jax" else _torch_state)(0)
    save = jck.checkpoint_save if writer == "jax" else tck.checkpoint_save
    save(src_domain, src_state, path, optstate=slots)
    for reader, make, load in (("jax", _jax_state, jck.checkpoint_load), ("torch", _torch_state, tck.checkpoint_load)):
        domain, state = make(1)
        assert not np.array_equal(_packed(domain, state), _packed(src_domain, src_state))
        opt = load(domain, state, path)
        np.testing.assert_array_equal(_packed(domain, state), _packed(src_domain, src_state), err_msg=reader)
        assert sorted(opt) == ["m", "step", "v"] and int(opt["step"]) == 7
        np.testing.assert_array_equal(opt["m"][0], slots["m"][0])
    with open(path, "rb") as f:
        assert sorted(pickle.load(f)) == ["fields", "optimizer"]


def test_checkpoint_keeps_bfloat16_slots_as_float32(tmp_path):
    from odil_torch import checkpoint as tck

    domain, state = _torch_state(0)
    m = torch.tensor([0.5, 1.25], dtype=torch.bfloat16)
    tck.checkpoint_save(domain, state, str(tmp_path / "ck.pickle"), optstate={"m": [m], "step": 3})
    opt = tck.checkpoint_load(domain, state, str(tmp_path / "ck.pickle"))
    assert opt["m"][0].dtype == np.float32
    np.testing.assert_array_equal(opt["m"][0], [0.5, 1.25])


# -- the harness API: resume, optimizers, schedule ------------------------------


def _vt_args(**kw):
    from odil_torch.examples import veltracer

    argv = ["--Nx", "8", "--kernel", "xla", "--double", "1", "--plot_every", "0", "--device", "cpu"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)] if v is not None else []
    args = veltracer.parse_args(argv)
    args.Nt = args.Ny = args.Nx
    return args


def _vt_run(args, outdir, optstate=None, state_from=None):
    """The veltracer CLI's steps with an optional resume: (problem, state)."""
    from odil_torch.examples import veltracer

    args.outdir = str(outdir)
    todil.setup_outdir(args)
    problem, state = veltracer.make_problem(args)
    if state_from is not None:
        problem.resume_opt_state = todil.core.checkpoint_load(problem.domain, state, state_from)
    todil.optimize(args, args.optimizer, problem, state, todil.make_callback(problem, args))
    return problem, state


def test_adam_resume_with_slots_reproduces_the_rows(outdir):
    """20 epochs in one run against 10, a checkpoint with the Adam slots,
    and 10 more resumed from it: rows 11-20 equal to the bit; the resumed
    run's epoch-10 row (the state after 10 updates, by eval_loss_grad)
    equals the first run's epoch-11 row (the same state, by the training
    step), rtol 1e-12."""
    _vt_run(_vt_args(epochs=20, history_every=1), outdir / "full")
    _vt_run(_vt_args(epochs=10, history_every=1, checkpoint_every=10), outdir / "first")
    ck = str(outdir / "first" / "checkpoint_000010.pickle")
    with open(ck, "rb") as f:
        slots = pickle.load(f)["optimizer"]
    assert sorted(slots) == ["m", "step", "v"] and int(slots["step"]) == 10
    _vt_run(_vt_args(epochs=20, history_every=1, epoch_start=10), outdir / "resumed", state_from=ck)
    full = {int(r["epoch"]): r for r in _read_csv(outdir / "full" / "train.csv")}
    resumed = {int(r["epoch"]): r for r in _read_csv(outdir / "resumed" / "train.csv")}
    assert sorted(resumed) == list(range(10, 21))
    for e in range(11, 21):
        for col in [c for c in full[e] if c.startswith("norm_")] + ["loss"]:
            assert resumed[e][col] == full[e][col], (e, col)
    np.testing.assert_allclose(float(resumed[10]["loss"]), float(full[11]["loss"]), rtol=1e-12)


def test_resume_without_slots_differs(outdir):
    """Loading only the fields restarts the moments cold, so the rows after
    the checkpoint move (the check above would pass vacuously if the slots
    were ignored)."""
    _vt_run(_vt_args(epochs=10, history_every=1, checkpoint_every=10), outdir / "first")
    ck = str(outdir / "first" / "checkpoint_000010.pickle")
    _vt_run(_vt_args(epochs=12, history_every=1, epoch_start=10), outdir / "warm", state_from=ck)
    args = _vt_args(epochs=12, history_every=1, epoch_start=10)
    args.outdir = str(outdir / "cold")
    todil.setup_outdir(args)
    from odil_torch.examples import veltracer

    problem, state = veltracer.make_problem(args)
    todil.core.checkpoint_load(problem.domain, state, ck)
    todil.optimize(args, args.optimizer, problem, state, todil.make_callback(problem, args))
    warm = {r["epoch"]: r["loss"] for r in _read_csv(outdir / "warm" / "train.csv")}
    cold = {r["epoch"]: r["loss"] for r in _read_csv(outdir / "cold" / "train.csv")}
    assert warm["10"] == cold["10"] and warm["12"] != cold["12"]


SCHEDULES = [
    # (report_every, history_every, plot_every, checkpoint_every, history_full, epoch_start, epochs)
    (100, 10, 0, 0, 5, 0, 100),  # tests/test_optimize.py::test_compute_task_epochs
    (100, 10, 0, 0, 0, 0, 400),  # the flagship CLI
    (10, 10, 100, 0, 5, 0, 20),  # the wave CLI
    (0, 0, 0, 0, 0, 0, 7),
    (3, 0, 5, 4, 0, 10, 25),
    (100, 1, 0, 0, 0, 50, 60),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: "-".join(map(str, s)))
def test_task_epochs_and_chunks_match_the_jax_package(sched):
    import odil_tpu.util as jutil
    from odil_tpu.optim.base import plan_chunks as jplan

    names = ("report_every", "history_every", "plot_every", "checkpoint_every", "history_full")
    args = argparse.Namespace(**dict(zip(names, sched[:5])))
    start, epochs = sched[5:]
    tasks = tutil.compute_task_epochs(args, start, epochs)
    assert tasks == jutil.compute_task_epochs(args, start, epochs)
    for max_chunk in (512, 7):
        got = list(tbase.plan_chunks(start, epochs, tasks, max_chunk))
        assert got == list(jplan(start, epochs, tasks, max_chunk))
        assert sum(got) == epochs and set(tasks) <= {start + int(c) for c in np.cumsum(got)}
    assert list(tbase.plan_chunks(start, 5, None)) == list(jplan(start, 5, None)) == [1] * 5


@pytest.mark.parametrize("nsteps,tasks,last_only", [(4, None, False), (4, [4, 9], False), (3, [4, 9], False),
                                                     (5, [5], True)])
def test_emit_matches_the_jax_package(nsteps, tasks, last_only):
    """Optimizer._emit on the same stacked (losses, terms, norms): the same
    callbacks with the same pinfo (exact); the port also takes terms and
    norms that keep only the chunk's last row, as its device loop passes
    them."""
    from odil_tpu.optim.base import Optimizer as JOptimizer

    rng = np.random.default_rng(nsteps)
    losses, terms = rng.normal(size=nsteps), rng.normal(size=(nsteps, 3))
    norms = np.sqrt(np.abs(terms))
    calls = {}
    for name, opt in (("jax", JOptimizer()), ("torch", tbase.Optimizer())):
        opt.bind(None, task_epochs=tasks, names=["a", "", "c"])
        seen = calls[name] = []
        stacked = (losses, terms, norms)
        if name == "torch":
            stacked = (torch.tensor(losses), torch.tensor(terms[-1:] if last_only else terms),
                       torch.tensor(norms[-1:] if last_only else norms))
        opt._emit(lambda x, e, p: seen.append((x, e, p)), "arrays", 1, stacked, nsteps)
    assert len(calls["jax"]) == len(calls["torch"]) == (tasks is None or 1 + nsteps in tasks)
    for (xa, ea, pa), (xb, eb, pb) in zip(calls["jax"], calls["torch"]):
        assert (xa, ea) == (xb, eb) and pa.keys() == pb.keys() and pa["names"] == pb["names"]
        for k in ("loss", "terms", "norms"):
            np.testing.assert_array_equal(pb[k], pa[k])


@pytest.mark.parametrize("what", ["newton", "gn", "newton_mf", "poisson_mesh", "orbax"])
def test_unported_parts_raise(what, outdir):
    """The poisson CLI's --mesh, ported since, runs (a mesh axis that names
    no grid dimension: every array replicated) and gives the unsharded rows
    to the bit; Newton (plain fields, as the run scripts take it) and
    Gauss-Newton, ported since, run the veltracer CLI two epochs: rows at
    epochs 0-2, finite, the loss lower at the end.  --checkpoint_format
    orbax, ported since, runs the CLI two epochs with a checkpoint an epoch:
    the latest step is 2 and restoring it into a fresh state gives the run's
    final fields and its Adam slots."""
    if what == "poisson_mesh":  # the JAX package's GSPMD route
        from odil_torch.examples import poisson

        rows = []
        for name, mesh in (("plain", ()), (what, ("--mesh", "t:2"))):
            poisson.main(["--N", "8", "--epochs", "2", "--history_every", "1", "--device", "cpu", *mesh, "--outdir",
                          str(outdir / name)])
            rows.append([{k: v for k, v in r.items() if k not in ("walltime", "memory")}
                         for r in _read_csv(outdir / name / "train.csv")])
        assert rows[0] == rows[1] and len(rows[0]) == 3
        return
    args = _vt_args(epochs=2, history_every=1, **({"multigrid": 0} if what == "newton" else {}))
    if what == "orbax":
        from odil_torch.examples import veltracer

        args.checkpoint_format, args.checkpoint_every, args.outdir = "orbax", 1, str(outdir / what)
        todil.setup_outdir(args)
        problem, state = veltracer.make_problem(args)
        callback = todil.make_callback(problem, args)
        todil.optimize(args, args.optimizer, problem, state, callback)
        ckpt = callback.cbinfo.orbax
        ckpt.wait()
        assert ckpt.latest_step() == 2 and sorted(os.listdir(outdir / what / "checkpoint_orbax")) == ["0", "1", "2"]
        _, fresh = veltracer.make_problem(args)
        slots = ckpt.restore(problem.domain, fresh)
        domain = problem.domain
        for a, b in zip(domain.arrays_from_state(fresh), domain.arrays_from_state(state)):
            assert torch.equal(a, b)
        assert int(slots["step"]) == 2 and len(slots["m"]) == len(slots["v"]) == len(domain.arrays_from_state(state))
        ckpt.close()
        return
    args.optimizer = what
    problem, _ = _vt_run(args, outdir / what)
    with open(outdir / what / "train.csv") as fh:
        rows = list(csv.DictReader(fh))
    losses = [float(r["loss"]) for r in rows]
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2] and np.all(np.isfinite(losses)), rows
    assert losses[2] < losses[0] and problem.solver_stats["epochs"] == 2


def _quadratic(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n), rng.uniform(0.5, 2.0, size=n)


@pytest.mark.parametrize("name", ["adam", "gd"])
def test_eager_loops_match_the_jax_package(name):
    """The eager path (no bound loss function; the reference's loop over a
    loss_grad callable): the same iterates and callbacks, fp64 rtol 1e-12."""
    import jax.numpy as jnp
    from odil_tpu.optim import make_optimizer as jmake

    ref, w = _quadratic()
    out = {}
    for pkg, make, conv in (("jax", jmake, jnp.asarray), ("torch", tbase.make_optimizer, torch.tensor)):
        wv, rv = conv(w), conv(ref)

        def loss_grad(x, wv=wv, rv=rv):
            d = x[0] - rv
            return (w * np.asarray(d) ** 2).sum(), [2 * wv * d], {"epoch": None}

        seen = []
        x, info = make(name, dtype=np.float64).run(
            [conv(np.zeros(6))], loss_grad=loss_grad, epochs=7, callback=lambda x, e, p: seen.append(e), lr=0.1,
            epoch_start=3)
        out[pkg] = (np.asarray(x[0]), seen, info.evals)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-12)
    assert out["torch"][1:] == out["jax"][1:] == (list(range(4, 11)), 7)


def _fit_problem(odil, cpu):
    domain = odil.Domain(cshape=(8, 8), dimnames=["x", "y"], multigrid=True, dtype=np.float64,
                         **({"device": "cpu"} if cpu else {}))
    ref = np.random.default_rng(0).normal(size=(8, 8))

    def operator(ctx):
        return [("fit", ctx.field("u") - ctx.extra.ref), ("reg", 0.1 * ctx.field("u"))]

    state = domain.init_state(odil.State(fields={"u": None}))
    return odil.Problem(operator, domain, argparse.Namespace(ref=domain.cast(ref))), state


@pytest.mark.parametrize("optname", ["gd", "adam", "lbfgsb"])
def test_optimize_grad_matches_the_jax_package(optname, outdir):
    """util.optimize_grad with make_callback on a small fp64 multigrid fit:
    train.csv's epoch, frame, norm_* and loss rows within rtol 1e-7 of the
    JAX package's (the device loops of GD and Adam, L-BFGS-B on the host)."""
    import odil_tpu as jodil

    rows = {}
    for name, odil, cpu in (("jax", jodil, False), ("torch", todil, True)):
        os.makedirs(outdir / name)
        os.chdir(outdir / name)
        args = argparse.Namespace(
            epochs=12, epoch_start=0, lr=0.05, report_every=5, history_every=2, plot_every=4, checkpoint_every=0,
            history_full=3, frames=1, frame_start=0, callback_update_state=0, bfgs_m=10, bfgs_maxls=20,
            bfgs_pgtol=None, adam_epsilon=None, adam_beta_1=None, adam_beta_2=None, max_chunk=512,
        )
        problem, state = _fit_problem(odil, cpu)
        odil.util.optimize(args, optname, problem, state, odil.make_callback(problem, args))
        rows[name] = _read_csv("train.csv")
        odil.make_callback  # noqa: B018
    _rows_close(rows["torch"], rows["jax"], ("epoch", "frame", "norm_fit", "norm_reg", "loss"))


def _rows_close(got, want, cols, rtol=RTOL):
    """Every row's `cols` within rtol; returns the largest relative distance."""
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    assert list(got[0]) == list(want[0])
    worst = 0.0
    for a, b in zip(got, want):
        for c in cols:
            np.testing.assert_allclose(float(a[c]), float(b[c]), rtol=rtol, atol=0, err_msg=f"epoch {a['epoch']} {c}")
            if float(b[c]):
                worst = max(worst, abs(float(a[c]) - float(b[c])) / abs(float(b[c])))
    return worst


def test_problem_and_domain_helpers_match_the_jax_package():
    """eval_loss_grad, eval_operator, get_context, Domain.field (shifted),
    pack/unpack_state, arrays_to_state, step_by_dim and state_size on a
    multigrid state with a net and an array: fp64 rtol 1e-12."""
    import jax.numpy as jnp
    import odil_tpu as jodil
    from odil_tpu.fields import state_size as jsize

    from odil_torch.fields import state_size as tsize

    jd, js = _jax_state(0)
    td, ts = _torch_state(0)
    packed = _packed(jd, js)
    np.testing.assert_array_equal(_packed(td, ts), packed)
    rng = np.random.default_rng(5)
    new = rng.normal(size=packed.shape)
    assert jd.unpack_state(jnp.asarray(new), js) == td.unpack_state(torch.tensor(new), ts) == packed.size
    np.testing.assert_array_equal(_packed(td, ts), _packed(jd, js))
    assert tsize(ts) == jsize(js) == packed.size
    assert td.step_by_dim(1) == jd.step_by_dim(1)
    for key, shift in (("u", (1, -1)), ("mg", ()), ("a", ())):
        np.testing.assert_allclose(td.field(ts, key, *shift).numpy(), np.asarray(jd.field(js, key, *shift)),
                                   rtol=1e-12)
    arrays = [rng.normal(size=tuple(a.shape)) for a in td.arrays_from_state(ts)]
    assert jd.arrays_to_state([jnp.asarray(a) for a in arrays], js) == td.arrays_to_state(
        [torch.tensor(a) for a in arrays], ts) == len(arrays)

    def operator(odil):
        def op(ctx):
            net = ctx.neural_net("net")
            u = ctx.field("u")
            return [("u", u - ctx.field("mg")), ("n", net(u, u)[0] * ctx.field("a")[0]), ctx.field("u", 1, 0)]

        return op

    jp, tp = jodil.Problem(operator(jodil), jd), todil.Problem(operator(todil), td)
    jl, jg, jt, jn, jno = jp.eval_loss_grad(js)
    tl, tg, tt, tn, tno = tp.eval_loss_grad(ts)
    assert tn == jn == ["u", "n", ""] and isinstance(tl, np.ndarray)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-12)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=1e-12)
    np.testing.assert_allclose(tno, np.asarray(jno), rtol=1e-12)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12 * float(np.abs(b).max()))
    (jv, jnames), (tv, tnames) = jp.eval_operator(js), tp.eval_operator(ts)
    assert tnames == jnames
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    ctx = tp.get_context(ts)
    assert ctx.state is ts and ctx.tracers is tp.tracers and td.get_context(ts).domain is td


def test_remat_gives_the_same_loss_and_gradients():
    """Problem(remat=True) recomputes the operator in the backward pass
    (torch.utils.checkpoint): the same loss and gradients, to the bit."""
    from odil_torch.models import veltracer

    out = []
    for remat in (False, True):
        problem, state, extra = veltracer.build(nt=8, nx=8, ny=8, dtype=np.float64, device="cpu")
        problem = todil.Problem(problem.operator, problem.domain, extra, remat=remat, jit=True)
        rng = np.random.default_rng(0)
        problem.domain.arrays_to_state(
            [torch.tensor(rng.normal(size=tuple(a.shape))) for a in problem.domain.arrays_from_state(state)], state)
        out.append(problem.eval_loss_grad(state))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_setup_outdir_seeds_and_records(outdir):
    """setup_outdir writes args.json and train.log, rescales the cadences,
    seeds np.random and returns a torch.Generator seeded the same on the
    requested device; the global torch generator is left alone."""
    import json

    args = _vt_args(plot_every=10, every_factor=2, seed=7)
    args.outdir = str(outdir / "o")
    before = torch.random.get_rng_state()
    gen = todil.setup_outdir(args)
    assert os.getcwd() == str(outdir / "o") and os.path.isfile("train.log")
    assert (args.plot_every, args.history_every, args.report_every, args.epochs) == (20, 20, 200, 100)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert gen.device == torch.device("cpu") and gen.initial_seed() == 7
    assert np.random.get_state()[1][0] == np.random.RandomState(7).get_state()[1][0]
    with open("args.json") as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and rec["runtime_backend"] == "torch"
    todil.printlog("hello")
    with open("train.log") as f:
        assert "hello" in f.read()


@pytest.mark.parametrize("flag", ["bfloat16", "float32"])
def test_adam_slot_dtype_flag(flag, outdir):
    args = _vt_args(epochs=4, history_every=2, adam_slot_dtype=flag, double=0)
    problem, _ = _vt_run(args, outdir / flag)
    opt = problem._active_optimizer
    assert opt.slot_dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[flag]
    assert opt.slots["m"][0].dtype == opt.slot_dtype and opt.slots["step"] == 4


def test_profile_dir_writes_a_trace(outdir):
    args = _vt_args(epochs=3, history_every=1, profile_dir=str(outdir / "trace"))
    _vt_run(args, outdir / "p")
    assert os.path.isfile(outdir / "trace" / "trace.json")


def test_device_memory_is_zero_on_the_cpu():
    assert tutil.get_device_memory_usage_kb("cpu") == (0, 0)
    assert tutil.get_memory_usage_kb() > 0


# -- end to end: the CLIs against the JAX package's examples ---------------------

VT_ARGV = ["--Nx", "16", "--double", "1", "--epochs", "30", "--history_every", "5", "--plot_every", "0"]
WAVE_ARGV = ["--Nt", "32", "--Nx", "32", "--optimizer", "lbfgsb", "--epochs", "20", "--history_every", "1"]
WAVE_EXACT_UNTIL = 12  # rows up to this epoch are held to rtol 1e-7


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's two examples, each in its own process (a float64
    Domain switches x64 on for the whole process), run side by side:
    {name: train.csv rows}."""
    base = tmp_path_factory.mktemp("jax_examples")
    runs = {
        "veltracer": (os.path.join(ROOT, "examples", "velocity_from_tracer", "veltracer.py"),
                      VT_ARGV + ["--kernel", "xla"]),
        "wave": (os.path.join(ROOT, "examples", "wave", "wave.py"), WAVE_ARGV),
    }
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {
        name: subprocess.Popen([sys.executable, script, *argv, "--outdir", str(base / name)], cwd=str(base), env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (script, argv) in runs.items()
    }
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log[-3000:]
        out[name] = _read_csv(base / name / "train.csv")
    return out


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_mg"])
def test_veltracer_cli_matches_the_jax_example(kernel, jax_runs, outdir):
    from odil_torch.examples import veltracer

    problem, state = veltracer.main(VT_ARGV + ["--kernel", kernel, "--device", "cpu", "--outdir", "out"])
    assert problem.domain.device == torch.device("cpu") and state.initialized
    rows = _read_csv(outdir / "out" / "train.csv")
    want = jax_runs["veltracer"]
    assert len(rows) == 7
    worst = _rows_close(rows, want, ["epoch", "frame", "loss"] + [c for c in want[0] if c.startswith("norm_")])
    print(f"veltracer 16^3 --kernel {kernel}: largest relative distance from the JAX package's rows {worst:.3e}")


@pytest.mark.parametrize("fuse", ["generic", "mg"])
def test_veltracer_cli_halo_flags(fuse, outdir):
    """--mesh t:2,x:2 --halo 1 --halo_fuse: the per-shard routes on four
    shards of the CPU, every row within fp64 rtol 1e-10 of the unsharded
    run."""
    from odil_torch.examples import veltracer

    argv = ["--Nx", "16", "--kernel", "pallas_mg", "--double", "1", "--epochs", "10", "--history_every", "5",
            "--plot_every", "0", "--device", "cpu"]
    veltracer.main(argv + ["--outdir", str(outdir / "whole")])
    os.chdir(outdir)
    veltracer.main(argv + ["--mesh", "t:2,x:2", "--halo", "1", "--halo_fuse", fuse, "--outdir", str(outdir / "halo")])
    rows = _read_csv(outdir / "halo" / "train.csv")
    _rows_close(rows, _read_csv(outdir / "whole" / "train.csv"), ["epoch", "loss"], rtol=1e-10)
    with open(outdir / "halo" / "train.log") as f:
        assert "partition: {'t': 't', 'x': 'x'}" in f.read()


@pytest.mark.parametrize("cli", ["veltracer", "wave"])
def test_clis_default_to_the_card(cli, outdir):
    """Without --device the CLIs put their tensors on the card; with no card
    (this CPU-only torch) they raise instead of falling back to the CPU."""
    import importlib

    mod = importlib.import_module(f"odil_torch.examples.{cli}")
    assert mod.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            mod.main(["--Nx", "8", "--Nt", "8", "--epochs", "1", "--optimizer", "adam", "--outdir", str(outdir / cli)])


def _wave_rows(argv, path):
    from odil_torch.examples import wave

    wave.main(argv + ["--device", "cpu", "--outdir", path])
    assert os.path.isfile(os.path.join(path, "done"))
    return _read_csv(os.path.join(path, "train.csv"))


def test_wave_cli_matches_the_jax_example(jax_runs, outdir, monkeypatch):
    want = jax_runs["wave"]
    rows = _wave_rows(WAVE_ARGV, str(outdir / "out"))
    assert [r["frame"] for r in rows] == [r["frame"] for r in want] and want[-1]["frame"] == "1"
    exact = [i for i, r in enumerate(want) if int(r["epoch"]) <= WAVE_EXACT_UNTIL]
    worst = _rows_close([rows[i] for i in exact], [want[i] for i in exact], ["epoch", "loss", "error_u", "norm_fu"])
    print(f"wave 32^2 epochs 0-{WAVE_EXACT_UNTIL}: largest relative distance from the JAX package's rows {worst:.3e}")

    # The spread that one-ulp noise on the port's own gradients causes.
    from odil_torch.problem import Problem

    orig, rng = Problem.eval_loss_grad, np.random.default_rng(1)

    def noisy(self, state):
        loss, grads, *rest = orig(self, state)
        eps = np.finfo(np.float64).eps
        return (loss, [g * (1 + torch.tensor(rng.uniform(-eps, eps, size=tuple(g.shape)))) for g in grads], *rest)

    monkeypatch.setattr(Problem, "eval_loss_grad", noisy)
    os.chdir(outdir)
    noise = _wave_rows(WAVE_ARGV, str(outdir / "noisy"))
    assert [r["epoch"] for r in noise] == [r["epoch"] for r in rows]
    for a, b, n in zip(rows, want, noise):
        for c in ("loss", "error_u"):
            gap, spread = abs(float(a[c]) - float(b[c])), abs(float(n[c]) - float(a[c]))
            assert gap <= max(RTOL * abs(float(b[c])), 10 * spread), (a["epoch"], c, gap, spread)
    last = {c: float(rows[-1][c]) for c in ("loss", "error_u")}
    print("wave 32^2 epoch 20, relative: " + ", ".join(
        f"{c} port vs JAX {abs(last[c] - float(want[-1][c])) / last[c]:.3e}, port vs port with one-ulp noise "
        f"{abs(last[c] - float(noise[-1][c])) / last[c]:.3e}" for c in last))
