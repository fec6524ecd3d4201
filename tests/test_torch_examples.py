"""The port's remaining models and command-line examples against the JAX
package on the CPU, fp64.

Module level, at one seeded state carried across with
``convert.arrays_from_numpy`` (losses rtol 1e-12, gradients rtol 1e-10 with
atol 1e-12 * max|ref|):

- poisson (ndim 1-3, mgloss 0 and 1, ref hat and osc), advection (a
  node-located multigrid field beside an ``Array``), heat's ``operator_tmax``
  and ``operator_pinn`` (with and without ``infer_k``; nested
  ``torch.func.jvp`` then reverse mode);
- ``Approx``; ``latin_hypercube``, ``random_inner`` and ``random_boundary``
  at one numpy seed (exact);
- multigrid fields at each location (``cc``, ``nn``, ``nc``, ``cn``): the
  flatten, the seeding and the packed order.

The CLIs (``odil_torch.examples.*``) against the JAX package's examples at
the sizes of tests/test_examples.py.  The JAX examples run in three
subprocesses started with the module, each running this file as a script
(``python tests/test_torch_examples.py <subdir>|<module>|<argv>|<outdir>
...``).  Adam runs (poisson, heat ``--kernel xla`` and ``pallas``, fields,
heat ``--solver pinn``) start from the same state -- the heat runs from the
JAX run's epoch-0 checkpoint, whose nets are the JAX package's draws -- and
every ``train.csv`` row is within rtol 1e-7.  L-BFGS runs (infer_constant,
heat_tmax, wave; the default optimizer) amplify a one-ulp difference:
every row within rtol 1e-7 or 10 times the port's own
distance from a run whose gradients carry one-ulp noise.  A heat run resumed
from ``--checkpoint`` reproduces the uninterrupted rows to the bit.
"""

import argparse
import csv
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import odil_torch as todil  # noqa: E402
from odil_torch import util as tutil  # noqa: E402
from odil_torch.convert import arrays_from_numpy  # noqa: E402
from odil_torch.models import advection as tad  # noqa: E402
from odil_torch.models import heat as th  # noqa: E402
from odil_torch.models import poisson as tpo  # noqa: E402

RTOL = 1e-7
COMMON = ["--report_every", "1000000", "--plot_every", "1000000", "--frames", "0", "--echo", "0"]


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# -- module level --------------------------------------------------------------


def _same_state(jp, js, tp, ts, seed=0, scale=0.3):
    """Puts the same seeded arrays into both states."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    arrays = [scale * rng.normal(size=a.shape) for a in jp.domain.arrays_from_state(js)]
    assert [tuple(a.shape) for a in tp.domain.arrays_from_state(ts)] == [a.shape for a in arrays]
    jp.domain.arrays_to_state([jnp.asarray(a) for a in arrays], js)
    tp.domain.arrays_to_state(arrays_from_numpy(arrays, device="cpu"), ts)


def _match_loss_grad(jp, js, tp, ts, seed=0):
    """eval_loss_grad of both problems at the same state: names equal, loss
    and terms rtol 1e-12, gradients rtol 1e-10 with atol 1e-12 * max|ref|."""
    _same_state(jp, js, tp, ts, seed)
    jl, jg, jt, jn, _ = jp.eval_loss_grad(js)
    tl, tg, tt, tn, _ = tp.eval_loss_grad(ts)
    assert tn == jn and len(tg) == len(jg)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-12)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=1e-12)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12 * float(np.abs(b).max()))
    return tn


POISSON = [(1, "hat", 0), (1, "hat", 1), (2, "hat", 0), (2, "hat", 1), (2, "osc", 0), (2, "osc", 1), (3, "hat", 0),
           (3, "hat", 1)]


@pytest.mark.parametrize("ndim,ref,mgloss", POISSON, ids=lambda c: str(c))
def test_poisson_operator_matches_jax(ndim, ref, mgloss):
    from odil_tpu.models import poisson as jpo

    args = argparse.Namespace(ref=ref, rhs="discrete", osc_k=2.0, mgloss=mgloss)
    jp, js, je = jpo.build(n=8, ndim=ndim, args=args)
    tp, ts, te = tpo.build(n=8, ndim=ndim, args=args, device="cpu")
    np.testing.assert_allclose(_host(te.rhs), np.asarray(je.rhs), rtol=1e-12, atol=1e-12)
    assert len(_match_loss_grad(jp, js, tp, ts, seed=ndim)) == 1 + mgloss


def test_poisson_exact_rhs_and_mesh():
    from odil_tpu.models import poisson as jpo

    args = argparse.Namespace(ref="osc", rhs="exact", osc_k=2.0, mgloss=0)
    _, _, je = jpo.build(n=8, ndim=2, args=args)
    _, _, te = tpo.build(n=8, ndim=2, args=args, device="cpu")
    np.testing.assert_allclose(_host(te.rhs), np.asarray(je.rhs), rtol=1e-12)
    # With a mesh (the GSPMD route): the Domain takes it, and the loss and
    # gradients are the unsharded ones.
    mesh = todil.parallel.mesh_from_spec("x:2,y:2", devices=[torch.device("cpu")] * 4)
    tp, ts, _ = tpo.build(n=8, ndim=2, args=args, device="cpu")
    mp, ms, _ = tpo.build(n=8, ndim=2, args=args, device="cpu", mesh=mesh, partition={"x": "x", "y": "y"})
    assert mp.domain.mesh is mesh and mp.domain.partition == {"x": "x", "y": "y"}
    (l0, g0), (l1, g1) = (p.eval_loss_grad(s)[:2] for p, s in ((tp, ts), (mp, ms)))
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_advection_operator_matches_jax():
    """u at loc "nc" under multigrid beside the Array coeff: the flat order
    and coeff's gradient are the JAX package's."""
    from odil_tpu.models import advection as jad

    jp, js, je = jad.build(nt=8, nx=8)
    tp, ts, te = tad.build(nt=8, nx=8, device="cpu")
    assert list(ts.fields) == list(js.fields) == ["coeff", "u"]
    np.testing.assert_allclose(_host(te.u_final), np.asarray(je.u_final), rtol=1e-14)
    np.testing.assert_allclose(te.ref_u, np.asarray(je.ref_u), rtol=1e-14)
    _match_loss_grad(jp, js, tp, ts)


def test_tmax_operator_matches_jax():
    from odil_tpu.models import heat as jh

    jp, js, _ = jh.build_tmax(nt=8, nx=8)
    tp, ts, _ = th.build_tmax(nt=8, nx=8, device="cpu")
    np.testing.assert_array_equal(_host(tp.domain.pack_state(ts)), np.asarray(jp.domain.pack_state(js)))
    assert _match_loss_grad(jp, js, tp, ts) == ["eqn", "imp"]


def _pinn_args(infer_k):
    return argparse.Namespace(
        infer_k=infer_k, imposed="random", nimp=10, noise=0.0, seed=1000, kimp=2.0, kxreg=0, kxregdecay=0, ktreg=0,
        ktregdecay=0, kwreg=0, kwregdecay=0, kmax=0.1, keep_frozen=1, keep_init=1, solver="pinn", Nci=64, Ncb=8,
    )


def _pinn_problem(port, infer_k):
    """The PINN problem of the heat example at 8^2, the collocation points
    drawn after np.random.seed(3)."""
    import odil_tpu as jodil
    from odil_tpu.models import heat as jh

    args = _pinn_args(infer_k)
    hm, odil = (th, todil) if port else (jh, jodil)
    p, s, e = hm.build(nt=8, nx=8, dtype=np.float64, args=args, **({"device": "cpu"} if port else {}))
    d = p.domain
    np.random.seed(3)
    if port:
        th.pinn_collocation(d, args, e)
        net = d.make_neural_net([2, 6, 6, 1], torch.Generator().manual_seed(0))
    else:
        mod = d.mod
        e.t_inner, e.x_inner = d.random_inner(args.Nci)
        tb0, xb0 = d.random_boundary(1, 0, args.Ncb)
        tb1, xb1 = d.random_boundary(1, 1, args.Ncb)
        e.t_bound, e.x_bound = np.hstack((tb0, tb1)), np.hstack((xb0, xb1))
        e.t_init, e.x_init = d.random_boundary(0, 0, args.Ncb)
        e.u_init = jh.initial_temperature(mod.cast(e.t_init, d.dtype), mod.cast(e.x_init, d.dtype), mod)
        e.u_bound = jh.initial_temperature(mod.cast(e.t_bound, d.dtype), mod.cast(e.x_bound, d.dtype), mod)
        mod.random.set_seed(3)
        net = d.make_neural_net([2, 6, 6, 1])
    fields = {"u_net": net}
    if infer_k:
        fields["k_net"] = s.fields["k_net"]
    return odil.Problem(hm.operator_pinn, d, e), d.init_state(odil.State(fields=fields))


@pytest.mark.parametrize("infer_k", [0, 1])
def test_pinn_operator_matches_jax(infer_k):
    """Nested forward mode (torch.func.jvp) and reverse mode through the
    captured nets give the JAX package's loss and parameter gradients."""
    jp, js = _pinn_problem(False, infer_k)
    tp, ts = _pinn_problem(True, infer_k)
    assert _match_loss_grad(jp, js, tp, ts, seed=infer_k) == ["eqn", "bound", "init", "imp"]


def test_approx_matches_jax():
    import jax.numpy as jnp
    import odil_tpu as jodil
    from odil_tpu.stencil import Approx as JApprox

    jd = jodil.Domain(cshape=(6, 5), dimnames=["x", "y"], lower=(0, 0), upper=(1.5, 2), dtype=np.float64)
    td = todil.Domain(cshape=(6, 5), dimnames=["x", "y"], lower=(0, 0), upper=(1.5, 2), dtype=np.float64,
                      device="cpu")
    rng = np.random.default_rng(7)
    u, v = rng.normal(size=(6, 5)), rng.normal(size=(6, 5))
    ja, ta = JApprox(jd), todil.Approx(td)
    ju, tu = jnp.asarray(u), torch.tensor(u)
    jst, tst = ja.stencil(ju), ta.stencil(tu)
    pairs = [(ta.vorticity(tu, torch.tensor(v)), ja.vorticity(ju, jnp.asarray(v)))]
    pairs += list(zip(ta.central(tst), ja.central(jst)))
    pairs += list(zip(ta.stencil5(tst), ja.stencil5(jst)))
    pairs += list(zip(ta.apply_bc_extrap_linear(list(tst)), ja.apply_bc_extrap_linear(list(jst))))
    pairs += list(zip(ta.apply_bc_extrap_quad(list(tst), ta.stencil5(tst)),
                      ja.apply_bc_extrap_quad(list(jst), ja.stencil5(jst))))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    got = todil.struct_to_numpy(td.mod, {"a": [tu, (tu, 3)], "b": "s"})
    assert isinstance(got["a"][0], np.ndarray) and got["a"][1][1] == 3 and got["b"] == "s"


def test_random_points_match_jax():
    """latin_hypercube, random_inner and random_boundary draw the JAX
    package's points from numpy's global RNG (exact)."""
    import odil_tpu as jodil
    from odil_tpu.grid import latin_hypercube as jlh

    kw = dict(cshape=(8, 4, 4), lower=(0, -1, 2), upper=(1, 1, 5), dtype=np.float64)
    jd, td = jodil.Domain(**kw), todil.Domain(device="cpu", **kw)
    out = {}
    for name, d, lh in (("jax", jd, jlh), ("torch", td, todil.latin_hypercube)):
        np.random.seed(11)
        out[name] = [lh(3, 17, np.float32), *d.random_inner(20)] + [
            p for normal in range(3) for side in (0, 1) for p in d.random_boundary(normal, side, 9)]
    for a, b in zip(out["torch"], out["jax"], strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loc", ["cc", "nn", "nc", "cn"])
def test_multigrid_fields_at_each_location_match_jax(loc):
    """A node-located or staggered MultigridField: the seeded levels'
    shapes, the packed order and the flatten to the fine grid."""
    import jax.numpy as jnp
    import odil_tpu as jodil

    kw = dict(cshape=(8, 4), dimnames=["x", "y"], lower=(0, 0), upper=(2, 1), dtype=np.float64, multigrid=True)
    jd, td = jodil.Domain(**kw), todil.Domain(device="cpu", **kw)
    shape = tuple(jd.size(loc=loc))
    js = jd.init_state(jodil.State(fields={"a": [1.0, 2.0], "u": jodil.Field(np.zeros(shape), loc=loc)}))
    ts = td.init_state(todil.State(fields={"a": [1.0, 2.0], "u": todil.Field(np.zeros(shape), loc=loc)}))
    assert [tuple(a.shape) for a in td.arrays_from_state(ts)] == [a.shape for a in jd.arrays_from_state(js)]
    rng = np.random.default_rng(len(loc) + loc.count("n"))
    arrays = [rng.normal(size=a.shape) for a in jd.arrays_from_state(js)]
    jd.arrays_to_state([jnp.asarray(a) for a in arrays], js)
    td.arrays_to_state(arrays_from_numpy(arrays, device="cpu"), ts)
    np.testing.assert_array_equal(td.pack_state(ts).numpy(), np.asarray(jd.pack_state(js)))
    np.testing.assert_allclose(td.field(ts, "u").numpy(), np.asarray(jd.field(js, "u")), rtol=1e-13, atol=1e-13)


# -- the CLIs against the JAX examples -------------------------------------------

SIZES = {
    "poisson": ("poisson", "poisson", ["--N", "16", "--epochs", "60", "--history_every", "10", "--history_full", "0"]),
    "fields": ("basic", "fields", ["--epochs", "60", "--history_every", "10", "--double", "1", "--plot", "0"]),
    "infer_constant": ("infer_constant", "infer_constant", ["--Nt", "16", "--Nx", "16", "--epochs", "60",
                                                            "--history_every", "5"]),
    "heat_tmax": ("heat_tmax", "heat_tmax", ["--Nt", "16", "--Nx", "16", "--epochs", "60", "--history_every", "5"]),
    "wave": ("wave", "wave", ["--Nt", "16", "--Nx", "16", "--epochs", "40", "--history_every", "5",
                              "--history_full", "0"]),
    "heat": ("heat", "heat", ["--Nt", "16", "--Nx", "16", "--epochs", "40", "--infer_k", "1", "--imposed", "random",
                              "--nimp", "20", "--double", "1", "--history_every", "10", "--history_full", "0",
                              "--checkpoint_every", "40"]),
    "pinn": ("heat", "heat", ["--Nt", "16", "--Nx", "16", "--epochs", "40", "--solver", "pinn", "--Nci", "128",
                              "--Ncb", "16", "--infer_k", "1", "--imposed", "random", "--nimp", "16", "--double", "1",
                              "--history_every", "10", "--history_full", "0", "--checkpoint_every", "40"]),
}
GROUPS = [["heat", "pinn", "poisson"], ["wave", "fields"], ["heat_tmax", "infer_constant"]]


class JaxRuns:
    """The JAX examples of SIZES, run in the subprocesses of GROUPS started
    at construction; ``dir(name)`` waits for its group and returns the run's
    output directory."""

    def __init__(self, base):
        self.base = base
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.procs = {}
        for group in GROUPS:
            specs = ["|".join((SIZES[n][0], SIZES[n][1], " ".join(SIZES[n][2]), str(base / n))) for n in group]
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *specs], cwd=str(base), env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in group:
                self.procs[n] = proc
        self.logs = {}

    def dir(self, name):
        proc = self.procs[name]
        if proc not in self.logs:
            self.logs[proc], _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, self.logs[proc][-3000:]
        return self.base / name

    def close(self):
        for proc in set(self.procs.values()):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    yield runs
    runs.close()


@pytest.fixture
def outdir(tmp_path, monkeypatch):
    """A working directory for a CLI run; the cwd and the log sink are
    restored afterwards (setup_outdir chdirs and opens train.log)."""
    monkeypatch.chdir(tmp_path)
    sink = tutil._log_sink
    saved = sink.stream, sink.echo
    yield tmp_path
    if sink.stream is not saved[0]:
        sink.stream.close()
    sink.stream, sink.echo = saved


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _value_cols(row):
    """The columns that carry the run's numbers (not its timing or memory)."""
    return [c for c in row if c not in ("walltime", "memory", "gpu_used", "gpu_pool")]


def _cli(name, outdir, extra=()):
    """Runs the port's CLI of SIZES[name] on the CPU into outdir/name;
    returns its train.csv rows."""
    module = importlib.import_module(f"odil_torch.examples.{SIZES[name][1]}")
    out = str(outdir / name)
    module.main(SIZES[name][2] + COMMON + ["--device", "cpu", *extra, "--outdir", out])
    os.chdir(outdir)
    return _read_csv(os.path.join(out, "train.csv"))


def _rows_close(got, want, rtol=RTOL, noisy=()):
    """Every row's value columns within rtol of the JAX run's, or within 10
    times the port's largest distance from the runs `noisy` (their rows,
    runs with one-ulp gradient noise); returns the largest relative
    distance."""
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] and list(got[0]) == list(want[0])
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        for c in _value_cols(b):
            x, y = float(a[c]), float(b[c])
            limit = max([rtol * abs(y)] + [10 * abs(float(n[i][c]) - x) for n in noisy])
            assert abs(x - y) <= limit, (a["epoch"], c, x, y, limit)
            worst = max(worst, abs(x - y) / abs(y) if y else 0.0)
    return worst


def _start_from(jax_dir, outdir):
    """--checkpoint flags that start a heat run from the JAX run's epoch-0
    checkpoint (its initial nets) at epoch 0."""
    hist = todil.History()
    hist.append("epoch", 0)
    hist.append("frame", 0)
    hist.commit()
    hist.save(str(outdir / "epoch0_train.pickle"))
    return ["--checkpoint", str(jax_dir / "checkpoint_000000.pickle"), "--checkpoint_train",
            str(outdir / "epoch0_train.pickle")]


@pytest.mark.parametrize("name", ["poisson", "fields"])
def test_adam_cli_matches_the_jax_example(name, jax_runs, outdir):
    rows = _cli(name, outdir)
    want = _read_csv(jax_runs.dir(name) / "train.csv")
    assert len(rows) == 7 and "loss" in rows[0]
    print(f"{name}: largest relative distance from the JAX example's rows {_rows_close(rows, want):.3e}")
    if name == "poisson":
        assert os.path.isfile(outdir / name / "data.pickle") and "error_u" in rows[0]


@pytest.mark.parametrize("name,kernel", [("heat", "xla"), ("heat", "pallas"), ("pinn", "xla")])
def test_heat_cli_matches_the_jax_example(name, kernel, jax_runs, outdir):
    """From the JAX run's initial nets: the same imposed points, the rows
    within rtol 1e-7, the done file."""
    jdir = jax_runs.dir(name)
    rows = _cli(name, outdir, ["--kernel", kernel, *_start_from(jdir, outdir)])
    want = _read_csv(jdir / "train.csv")
    assert len(rows) == 5 and {"error_u", "error_k"} <= set(rows[0])
    assert (outdir / name / "imposed.csv").read_text() == (jdir / "imposed.csv").read_text()
    assert os.path.isfile(outdir / name / "done")
    print(f"{name} --kernel {kernel}: largest relative distance from the JAX example's rows "
          f"{_rows_close(rows, want):.3e}")


@pytest.mark.parametrize("name", ["infer_constant", "heat_tmax", "wave"])
def test_lbfgs_cli_matches_the_jax_example(name, jax_runs, outdir, monkeypatch):
    """The default optimizer (the on-device lbfgs): every row within rtol
    1e-7 or 10 times the port's own spread under one-ulp gradient noise.  In
    the stretch where L-BFGS amplifies roundoff the spread of one noisy run
    varies 30-fold from one noise draw to another (wave, epochs 30-40), so
    the spread is the largest of three draws."""
    from odil_torch.optim import base

    rows = _cli(name, outdir)
    want = _read_csv(jax_runs.dir(name) / "train.csv")
    orig = base.autograd_loss_grad_fn
    noisy = []
    for seed in range(3):
        rng = np.random.default_rng(seed)

        def grad_fn(loss_fn, rng=rng):
            fn = orig(loss_fn)

            def wrapped(arrays, tracers):
                out, grads = fn(arrays, tracers)
                eps = np.finfo(np.float64).eps
                return out, [g * (1 + torch.tensor(rng.uniform(-eps, eps, size=tuple(g.shape)))) for g in grads]

            return wrapped

        monkeypatch.setattr(base, "autograd_loss_grad_fn", grad_fn)
        noisy.append(_cli(name, outdir / f"noisy{seed}"))
    worst = _rows_close(rows, want, noisy=noisy)
    print(f"{name} (lbfgs): largest relative distance from the JAX example's rows {worst:.3e}")


def test_heat_cli_resumes_from_its_checkpoint(outdir):
    """20 epochs in one run against 10 with a checkpoint (the Adam slots)
    and 10 more from --checkpoint: rows 11-20 equal to the bit; the resumed
    run's epoch-10 row (the state after 10 updates, by eval_loss_grad)
    equals the first run's epoch-11 row (the same state, by the training
    step), rtol 1e-12."""
    from odil_torch.examples import heat

    base = ["--Nt", "16", "--Nx", "16", "--infer_k", "1", "--imposed", "random", "--nimp", "20", "--double", "1",
            "--history_every", "1", "--device", "cpu", *COMMON]
    heat.main(base + ["--epochs", "20", "--outdir", str(outdir / "full")])
    os.chdir(outdir)
    heat.main(base + ["--epochs", "10", "--checkpoint_every", "10", "--outdir", str(outdir / "first")])
    os.chdir(outdir)
    hist = todil.History()
    hist.append("epoch", 10)
    hist.append("frame", 0)
    hist.commit()
    hist.save(str(outdir / "first" / "checkpoint_000010_train.pickle"))
    heat.main(base + ["--epochs", "20", "--checkpoint", str(outdir / "first" / "checkpoint_000010.pickle"),
                      "--outdir", str(outdir / "resumed")])
    full = {int(r["epoch"]): r for r in _read_csv(outdir / "full" / "train.csv")}
    resumed = {int(r["epoch"]): r for r in _read_csv(outdir / "resumed" / "train.csv")}
    assert sorted(resumed) == list(range(10, 21))
    for e in range(11, 21):
        for c in ["loss", "error_u", "error_k"] + [c for c in full[e] if c.startswith("norm_")]:
            assert resumed[e][c] == full[e][c], (e, c)
    np.testing.assert_allclose(float(resumed[10]["loss"]), float(full[11]["loss"]), rtol=1e-12)


@pytest.mark.parametrize("shape", [(8, 12), (16, 16)], ids=["interpolated", "same_grid"])
def test_heat_ref_path_matches_jax(shape, outdir):
    """--ref_path: a checkpoint's u spline-interpolated to the grid (or taken
    as it is on the same grid) as the JAX example's load_fields_interp does
    it, and the CLI's reference and measurements taken from it."""
    import importlib.util
    import pickle

    import odil_tpu as jodil

    from odil_torch.examples import heat

    spec = importlib.util.spec_from_file_location("jax_heat_example", os.path.join(ROOT, "examples", "heat", "heat.py"))
    jheat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jheat)
    path = outdir / "ref.pickle"
    with open(path, "wb") as f:
        pickle.dump({"fields": {"u": [np.random.default_rng(5).normal(size=shape)]}}, f)
    jd = jodil.Domain(cshape=(16, 16), dimnames=("t", "x"), dtype=np.float64)
    td = todil.Domain(cshape=(16, 16), dimnames=("t", "x"), dtype=np.float64, device="cpu")
    want = np.asarray(jheat.load_fields_interp(str(path), ["u"], jd).fields["u"].array)
    got = heat.load_fields_interp(str(path), ["u"], td)["u"]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    problem, _ = heat.main(["--Nt", "16", "--Nx", "16", "--double", "1", "--imposed", "random", "--nimp", "20",
                            "--epochs", "2", "--ref_path", str(path), "--device", "cpu", *COMMON, "--outdir",
                            str(outdir / "run")])
    extra = problem.extra
    np.testing.assert_array_equal(extra.ref_u.numpy(), got)
    mask = extra.imp_mask.numpy() > 0
    np.testing.assert_array_equal(extra.imp_u.numpy()[mask], got[mask])


@pytest.mark.parametrize("cli", ["poisson", "heat", "heat_tmax", "infer_constant", "fields"])
def test_new_clis_default_to_the_card(cli, outdir):
    """Without --device the CLIs put their tensors on the card; with no card
    (this CPU-only torch) they raise instead of falling back to the CPU."""
    module = importlib.import_module(f"odil_torch.examples.{cli}")
    assert module.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            module.main(["--epochs", "1", "--outdir", str(outdir / cli)])


def _run_jax_examples(specs):
    """Runs the JAX package's examples in this process, one after another:
    each spec is '<subdir>|<module>|<argv>|<outdir>'."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("ODIL_DTYPE", "float64")
    for spec in specs:
        subdir, name, argv, out = spec.split("|")
        path = os.path.join(ROOT, "examples", subdir)
        sys.path.insert(0, path)
        cwd = os.getcwd()
        try:
            importlib.import_module(name).main(argv.split() + COMMON + ["--outdir", out])
        finally:
            os.chdir(cwd)
            sys.path.remove(path)
            sys.modules.pop(name, None)


if __name__ == "__main__":
    _run_jax_examples(sys.argv[1:])
