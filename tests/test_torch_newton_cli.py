"""The command-line examples with ``--optimizer newton`` and ``gn`` against
the JAX package's examples on the CPU in fp64, and the rows file that
chip_smoke.py's phase o holds the card to.

The JAX examples run in subprocesses started with the module, each running
this file as a script (``python tests/test_torch_newton_cli.py
'<subdir>|<module>|<argv>|<outdir>' ...``), as tests/test_torch_examples.py
runs them; the port's CLIs run in this process.  The run scripts' cases at
16^2 (poisson n and gn; wave n and gn; heat 0, the Newton forward
reference, and heat 2n from the JAX run's initial net with --ref_path at
case 0's checkpoint; veltracer gn with plain CG) and poisson n with
``--linsolver lsqr --linsolver_history 1`` (the same ``lin_*`` columns):
every ``train.csv`` row within rtol 1e-7 of the JAX run's, or both below
1e-12 of epoch 0's loss (1e-6 of its norms).

Truncated CG magnifies a one-ulp difference in the normal matvec, in
either package: the JAX package's own wave gn 64^2 rows move by 0.6% at
epoch 1 and by up to 29% at epoch 5 when its matvec is changed by one ulp
(``_perturb_jax_cg``).  So the Gauss-Newton cases here run CG budgets at
which the two packages' rows part by less than 1e-12 at 16^2 (poisson
20, wave 5, veltracer 3 iterations; at the run scripts' 100 and 10 they
part by up to 7e-3, 3e-3 and 2e-5).  The run scripts' budgets run on the
card, in chip_smoke.py's phase o, against the JAX package's own spread.

The JAX package's heat 2n meets an exactly singular normal matrix at its
first solve (the ``wreg`` term reads the state's net, which the
linearization does not bind, so it adds no rows on the net's weights): the
loss jumps at epoch 1 and is NaN from epoch 2.  The port reproduces it; its
epoch-0 row is held to rtol 1e-7 and its NaN rows to the JAX run's.

Run as a script with ``--write-rows``, the file writes
``odil_torch/data/newton_rows.json``: the JAX package's rows of phase o's
cases at the run scripts' sizes (CHIP), the fp64 rows of heat case 0 (the
fp32 run's yardstick), the fp64 veltracer gn rows at three seeds, heat
2n's initial net, and for the plain-CG Gauss-Newton cases (SPREAD) the
JAX package's own spread under three one-ulp changes of its CG operator.
``test_rows_file_*`` check that the file matches CHIP and that its
cheapest entry (poisson n at 64^2) is what the JAX package computes today.
"""

import csv
import importlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import odil_torch as todil  # noqa: E402
from odil_torch import util as tutil  # noqa: E402

DATA = os.path.join(ROOT, "odil_torch", "data", "newton_rows.json")
COMMON = ["--report_every", "1000000", "--plot_every", "1000000", "--frames", "0", "--echo", "0"]
RTOL = 1e-7
# The one-ulp perturbations of the JAX package's CG behind the rows file's
# spread (seeds of _perturb_jax_cg).
SPREAD_SEEDS = (0, 1, 2)
# Columns that carry the run's numbers (not its bookkeeping, timing or memory).
SKIP = ("epoch", "frame", "walltime", "memory", "gpu_used", "gpu_pool")

# The run scripts' cases at 16^2, fp64: (example subdir, module, argv).
SMALL = {
    "poisson_n": ("poisson", "poisson", "--N 16 --ref osc --rhs exact --optimizer newton --multigrid 0 --epochs 3 "
                  "--history_every 1"),
    "poisson_gn": ("poisson", "poisson", "--N 16 --ref osc --rhs exact --optimizer gn --multigrid 0 --epochs 3 "
                   "--history_every 1 --linsolver_maxiter 20"),
    "poisson_lsqr": ("poisson", "poisson", "--N 16 --ref osc --rhs exact --optimizer newton --multigrid 0 --epochs 2 "
                     "--history_every 1 --linsolver lsqr --linsolver_maxiter 40 --linsolver_history 1"),
    "wave_n": ("wave", "wave", "--Nt 16 --Nx 16 --optimizer newton --multigrid 0 --epochs 5 --history_every 1"),
    "wave_gn": ("wave", "wave", "--Nt 16 --Nx 16 --optimizer gn --epochs 3 --history_every 1 --linsolver_maxiter 5"),
    "heat0": ("heat", "heat", "--Nt 16 --Nx 16 --optimizer newton --multigrid 0 --epochs 6 --history_every 1 "
              "--double 1 --checkpoint_every 6"),
    "heat2n": ("heat", "heat", "--Nt 16 --Nx 16 --infer_k 1 --imposed stripe --optimizer newton --multigrid 0 "
               "--kwreg 1 --epochs 3 --history_every 1 --double 1 --checkpoint_every 3"),
    "vt_gn": ("velocity_from_tracer", "veltracer", "--Nx 16 --double 1 --linsolver direct --optimizer gn "
              "--linsolver_maxiter 3 --epochs 5 --history_every 1"),
}
GN = ("poisson_gn", "wave_gn", "vt_gn")

# Phase o's cases: the run scripts' flags (examples/*/run; heat2n cut to 5
# epochs), and wave gn with a CG budget of 3, at which roundoff stays below
# 1e-12.  heat2n takes --ref_path at heat0's checkpoint and heat0's initial
# net from the JAX run.
CHIP = {
    "poisson_n": ("poisson", "poisson", "--N 64 --ref osc --rhs exact --optimizer newton --multigrid 0 --epochs 3 "
                  "--report_every 1 --history_every 1"),
    "poisson_gn": ("poisson", "poisson", "--N 64 --ref osc --rhs exact --optimizer gn --multigrid 0 --epochs 3 "
                   "--report_every 1 --history_every 1"),
    "wave_n": ("wave", "wave", "--Nt 64 --Nx 64 --optimizer newton --multigrid 0 --epochs 5 --report_every 1 "
               "--history_every 1"),
    "wave_gn": ("wave", "wave", "--Nt 64 --Nx 64 --optimizer gn --epochs 5 --report_every 1 --history_every 1"),
    "wave_gn_cg3": ("wave", "wave", "--Nt 64 --Nx 64 --optimizer gn --epochs 5 --report_every 1 --history_every 1 "
                    "--linsolver_maxiter 3"),
    "heat0": ("heat", "heat", "--Nt 256 --Nx 256 --optimizer newton --multigrid 0 --report_every 5 --plot_every 5 "
              "--checkpoint_every 50 --epochs 50"),
    "heat2n": ("heat", "heat", "--Nt 64 --Nx 64 --infer_k 1 --imposed stripe --optimizer newton --multigrid 0 "
               "--kwreg 1 --report_every 5 --history_every 1 --plot_every 10 --epochs 5"),
    "vt_gn": ("velocity_from_tracer", "veltracer", "--Nx 64 --optimizer gn --linsolver_maxiter 10 --epochs 10 "
              "--report_every 1 --history_every 1"),
    "vt_gn64": ("velocity_from_tracer", "veltracer", "--Nx 64 --optimizer gn --linsolver_maxiter 10 --epochs 10 "
                "--report_every 1 --history_every 1 --double 1"),
}
VT_SEEDS = (1000, 1, 2)
# The plain-CG Gauss-Newton cases of CHIP held to the JAX package's spread.
SPREAD = ("poisson_gn", "wave_gn")


def _spec(subdir, module, argv, out):
    return "|".join((subdir, module, argv, str(out)))


class JaxRuns:
    """The JAX examples of SMALL (and the cheapest CHIP entry), run in
    subprocesses started at construction, one group each; ``dir(name)``
    waits for its group and returns the run's output directory."""

    def __init__(self, base):
        self.base = base
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        argv = {n: SMALL[n][2] + " " + " ".join(COMMON) for n in SMALL}
        argv["heat2n"] += f" --ref_path {base / 'heat0' / 'checkpoint_000006.pickle'}"
        small = {n: _spec(*SMALL[n][:2], argv[n], base / n) for n in SMALL}
        groups = {
            "a": [small["poisson_n"], small["poisson_gn"], small["poisson_lsqr"]],
            "b": [small["wave_n"], small["wave_gn"]],
            "c": [small["heat0"], small["heat2n"]],
            "d": [small["vt_gn"]],
            "e": [_spec(*CHIP["poisson_n"][:2], CHIP["poisson_n"][2] + " --plot_every 0", base / "chip_poisson_n")],
        }
        member = {"poisson_n": "a", "poisson_gn": "a", "poisson_lsqr": "a", "wave_n": "b", "wave_gn": "b",
                  "heat0": "c", "heat2n": "c", "vt_gn": "d", "chip_poisson_n": "e"}
        procs = {
            g: subprocess.Popen([sys.executable, os.path.abspath(__file__), *specs], cwd=str(base), env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for g, specs in groups.items()
        }
        self.procs = {n: procs[g] for n, g in member.items()}
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


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_newton"))
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("port_newton")


@pytest.fixture
def restore(monkeypatch):
    """Restores the working directory and the log sink after a CLI run
    (setup_outdir chdirs and opens train.log)."""
    monkeypatch.chdir(ROOT)
    sink = tutil._log_sink
    saved = sink.stream, sink.echo
    yield
    if sink.stream is not saved[0]:
        sink.stream.close()
    sink.stream, sink.echo = saved


def read_rows(path):
    """(columns, rows) of a train.csv: the value columns and, per row, the
    epoch and their values."""
    with open(path) as fh:
        recs = list(csv.DictReader(fh))
    cols = [c for c in recs[0] if c not in SKIP]
    return cols, [[int(float(r["epoch"]))] + [float(r[c]) for c in cols] for r in recs]


def run_port(module, argv, out, extra=()):
    """Runs the port's CLI `module` on the CPU into `out`; returns its rows
    and what main returned."""
    cli = importlib.import_module(f"odil_torch.examples.{module}")
    cwd = os.getcwd()
    try:
        result = cli.main(argv.split() + COMMON + ["--device", "cpu", *extra, "--outdir", str(out)])
    finally:
        os.chdir(cwd)
        sink = tutil._log_sink
        if sink.stream is not sys.stderr:
            sink.stream.close()
            tutil.set_log_file(sys.stderr)
    return read_rows(os.path.join(out, "train.csv")), result


def floors(cols, first):
    """Each column's floor: 1e-12 of epoch 0's loss, 1e-6 of epoch 0's
    norms; 0 (no floor) for the other columns."""
    out = []
    for c, v in zip(cols, first):
        out.append(1e-12 * abs(v) if c == "loss" else 1e-6 * abs(v) if c.startswith("norm_") else 0.0)
    return out


def within(got, want, cols, rtol=RTOL, skip_rows=()):
    """Every value of `got` within rtol of `want`'s, or both below the
    column's floor, or both NaN; rows whose epoch is in `skip_rows` only
    printed.  Returns the largest relative distance."""
    assert [r[0] for r in got] == [r[0] for r in want]
    fl = floors(cols, want[0][1:])
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a[0] in skip_rows:
            print(f"epoch {a[0]}: port {a[1:]} JAX {b[1:]} (not gated)")
            continue
        for j, (x, y) in enumerate(zip(a[1:], b[1:])):
            if np.isnan(y) and np.isnan(x):
                continue
            if abs(x) < fl[j] and abs(y) < fl[j]:
                continue
            assert abs(x - y) <= rtol * abs(y), (a[0], cols[j], x, y)
            worst = max(worst, abs(x - y) / abs(y) if y else 0.0)
    return worst


def start_from(jax_dir, out):
    """--checkpoint flags that start a heat run from the JAX run's epoch-0
    checkpoint (its initial net) at epoch 0."""
    hist = todil.History()
    hist.append("epoch", 0)
    hist.append("frame", 0)
    hist.commit()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "epoch0_train.pickle")
    hist.save(path)
    return ["--checkpoint", str(jax_dir / "checkpoint_000000.pickle"), "--checkpoint_train", path]


@pytest.mark.parametrize("name", ["poisson_n", "poisson_lsqr", "wave_n", "heat0"])
def test_newton_cli_matches_the_jax_example(name, jax_runs, port_dir, restore):
    subdir, module, argv = SMALL[name]
    (cols, got), (problem, _) = run_port(module, argv, port_dir / name)
    want_cols, want = read_rows(jax_runs.dir(name) / "train.csv")
    assert cols == want_cols
    if name == "poisson_lsqr":
        assert {"lin_residual", "lin_anorm", "lin_acond", "lin_niter"} <= set(cols)
    worst = within(got, want, cols)
    stats = problem.solver_stats
    print(f"{name}: largest relative distance from the JAX example's rows {worst:.3e}; {stats}")
    assert stats["epochs"] == got[-1][0]


def test_heat_2n_cli_reproduces_the_jax_example(jax_runs, port_dir, restore):
    """heat 2n from the JAX run's initial net, its reference from the port's
    own case 0: epoch 0 within rtol 1e-7; where the JAX run's normal matrix
    is singular (the ``wreg`` rows are zero; see the module docstring), the
    port's rows are NaN from the same epoch."""
    jdir = jax_runs.dir("heat2n")
    subdir, module, argv = SMALL["heat2n"]
    assert (port_dir / "heat0" / "checkpoint_000006.pickle").is_file(), "runs after the heat0 case"
    ref = ["--ref_path", str(port_dir / "heat0" / "checkpoint_000006.pickle")]
    (cols, got), _ = run_port(module, argv, port_dir / "heat2n", ref + start_from(jdir, port_dir / "heat2n_start"))
    want_cols, want = read_rows(jdir / "train.csv")
    assert cols == want_cols
    singular = "singular" in (jax_runs.base / "heat2n" / "train.log").read_text() or any(
        np.isnan(v) for r in want for v in r[1:])
    skip = (1,) if singular else ()
    worst = within(got, want, cols, skip_rows=skip)
    print(f"heat2n: singular {singular}; largest relative distance from the JAX example's gated rows {worst:.3e}")


@pytest.mark.parametrize("name", GN)
def test_gn_cli_matches_the_jax_example(name, jax_runs, port_dir, restore):
    subdir, module, argv = SMALL[name]
    (cols, got), (problem, _) = run_port(module, argv, port_dir / name)
    stats = dict(problem.solver_stats)
    want_cols, want = read_rows(jax_runs.dir(name) / "train.csv")
    assert cols == want_cols
    worst = within(got, want, cols)
    print(f"{name}: largest relative distance from the JAX example's rows {worst:.3e}; {stats}")
    n = stats["epochs"]
    assert n == got[-1][0] and stats["syncs"] >= n and stats["matvecs"] >= stats["iterations"] + n


# -- the rows file of phase o ------------------------------------------------------


def _load():
    with open(DATA) as fh:
        return json.load(fh)


def test_rows_file_matches_the_chip_cases():
    data = _load()
    assert set(data["cases"]) == set(CHIP)
    for name, (subdir, module, argv) in CHIP.items():
        case = data["cases"][name]
        assert (case["module"], case["argv"]) == (module, argv.split()), name
        assert len(case["rows"]) >= 3 and len(case["columns"]) == len(case["rows"][0]) - 1
    assert set(data["cases"]["vt_gn64"]["seeds"]) == {str(s) for s in VT_SEEDS}
    assert len(data["cases"]["heat0"]["rows_fp64"]) == len(data["cases"]["heat0"]["rows"])
    for name in SPREAD:
        case = data["cases"][name]
        assert len(case["jax_spread"]) == len(case["rows"])
        assert all(len(r) == len(case["columns"]) for r in case["jax_spread"])
    assert len(data["cases"]["heat2n"]["init_net"]["weights"]) == 3


def test_rows_file_cheapest_entry_is_the_jax_packages(jax_runs):
    """poisson n at 64^2: the JAX example's rows today equal the stored ones
    to the bit, so the file cannot drift from the JAX package."""
    cols, rows = read_rows(jax_runs.dir("chip_poisson_n") / "train.csv")
    case = _load()["cases"]["poisson_n"]
    assert cols == case["columns"]
    assert rows == case["rows"]


# -- script mode ---------------------------------------------------------------------


def _perturb_jax_cg(seed):
    """Replaces ``jax.scipy.sparse.linalg.cg``, which the JAX package's
    ``gauss_newton_step`` calls, by the same CG on the operator A(v) * (1 + u),
    u uniform in +-eps of b's dtype, drawn once a trace from a numpy generator
    seeded with `seed`: a one-ulp change of the normal matvec, as another
    evaluation order of it would make."""
    import jax.numpy as jnp
    import jax.scipy.sparse.linalg as jsl

    rng = np.random.default_rng(seed)
    exact = jsl.cg

    def cg(A, b, *args, **kw):
        eps = np.finfo(b.dtype).eps
        u = jnp.asarray(1 + rng.uniform(-eps, eps, size=b.shape), dtype=b.dtype)
        return exact(lambda v: A(v) * u, b, *args, **kw)

    jsl.cg = cg


def _run_jax_examples(specs):
    """Runs the JAX package's examples in this process, one after another:
    each spec is '<subdir>|<module>|<argv>|<outdir>', or with a fifth field,
    a seed, the same with ``_perturb_jax_cg(seed)`` in force."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("ODIL_DTYPE", "float64")
    exact_cg = jax.scipy.sparse.linalg.cg
    for spec in specs:
        subdir, name, argv, out, *noise = spec.split("|")
        jax.scipy.sparse.linalg.cg = exact_cg
        if noise:
            _perturb_jax_cg(int(noise[0]))
        path = os.path.join(ROOT, "examples", subdir)
        sys.path.insert(0, path)
        cwd = os.getcwd()
        try:
            importlib.import_module(name).main(argv.split() + ["--echo", "0", "--outdir", out])
        finally:
            os.chdir(cwd)
            sys.path.remove(path)
            sys.modules.pop(name, None)


def _spread_groups(base):
    """The JAX runs behind the spread of the SPREAD cases: each case once for
    every seed of SPREAD_SEEDS, with ``_perturb_jax_cg(seed)`` in force;
    one group (subprocess) for each seed."""
    return [[_spec(*CHIP[n][:2], CHIP[n][2] + " --plot_every 0", base / f"{n}_noise{seed}") + f"|{seed}"
             for n in SPREAD] for seed in SPREAD_SEEDS]


def _jax_spread(cases, base):
    """The JAX package's own spread of the SPREAD cases: by row and column,
    the largest distance of the perturbed runs of ``_spread_groups`` from the
    unperturbed rows."""
    for name in SPREAD:
        want = np.array(cases[name]["rows"])[:, 1:]
        spread = np.zeros_like(want)
        for seed in SPREAD_SEEDS:
            rows = np.array(read_rows(base / f"{name}_noise{seed}" / "train.csv")[1])[:, 1:]
            spread = np.maximum(spread, np.abs(rows - want))
        cases[name]["jax_spread"] = spread.tolist()


ABOUT = ("The JAX package's train.csv rows of chip_smoke.py's phase o cases (examples/*/run flags, CPU, plots off), "
         "written by `python tests/test_torch_newton_cli.py --write-rows`: rows are [epoch, *columns]; "
         "heat0.rows_fp64 the same run with --double 1; vt_gn64.seeds the fp64 veltracer gn rows at three seeds; "
         "heat2n.init_net the JAX run's initial conductivity net; poisson_gn/wave_gn.jax_spread the JAX package's "
         "own spread, by row and column: the largest distance from its rows of three runs whose CG operator is "
         "changed by one ulp.")


def _save(cases):
    with open(DATA, "w") as fh:
        json.dump({"about": ABOUT, "cases": cases}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {os.path.relpath(DATA, ROOT)}")


def _write_rows(base):
    """Writes DATA from the JAX examples at CHIP and their perturbed runs
    (run in parallel subprocesses under `base`, without plots)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_argv = {n: CHIP[n][2] + " --plot_every 0" for n in CHIP}
    groups = [
        [_spec(*CHIP["heat0"][:2], jax_argv["heat0"], base / "heat0"),
         _spec(*CHIP["heat2n"][:2], jax_argv["heat2n"] + " --checkpoint_every 50 --ref_path "
               + str(base / "heat0" / "checkpoint_000050.pickle"), base / "heat2n")],
        [_spec(*CHIP["heat0"][:2], jax_argv["heat0"] + " --double 1", base / "heat0_fp64")],
        [_spec(*CHIP[n][:2], jax_argv[n], base / n) for n in ("poisson_n", "poisson_gn", "wave_n", "wave_gn")],
        [_spec(*CHIP["wave_gn_cg3"][:2], jax_argv["wave_gn_cg3"], base / "wave_gn_cg3")],
        [_spec(*CHIP["vt_gn"][:2], jax_argv["vt_gn"], base / "vt_gn"),
         _spec(*CHIP["vt_gn64"][:2], jax_argv["vt_gn64"], base / "vt_gn64")],
        [_spec(*CHIP["vt_gn64"][:2], jax_argv["vt_gn64"] + f" --seed {s}", base / f"vt_gn64_seed{s}")
         for s in VT_SEEDS[1:]],
    ] + _spread_groups(base)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *g], cwd=str(base), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for g in groups]
    cases = {name: {"subdir": subdir, "module": module, "argv": argv.split()}
             for name, (subdir, module, argv) in CHIP.items()}
    for proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log[-3000:]
    for name in CHIP:
        cases[name]["columns"], cases[name]["rows"] = read_rows(base / name / "train.csv")
    cases["heat0"]["rows_fp64"] = read_rows(base / "heat0_fp64" / "train.csv")[1]
    seeds = {str(VT_SEEDS[0]): cases["vt_gn64"]["rows"]}
    for s in VT_SEEDS[1:]:
        seeds[str(s)] = read_rows(base / f"vt_gn64_seed{s}" / "train.csv")[1]
    cases["vt_gn64"]["seeds"] = seeds
    with open(base / "heat2n" / "checkpoint_000000.pickle", "rb") as fh:
        net = pickle.load(fh)["fields"]["k_net"]
    n = len(net) // 2
    cases["heat2n"]["init_net"] = {"weights": [np.asarray(w).tolist() for w in net[:n]],
                                   "biases": [np.asarray(b).tolist() for b in net[n:]]}
    _jax_spread(cases, base)
    _save(cases)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-rows"]:
        import pathlib
        import tempfile

        _write_rows(pathlib.Path(tempfile.mkdtemp(prefix="newton_rows_")))
    else:
        _run_jax_examples(sys.argv[1:])
