"""Plots and post-processing of the port against the JAX package on the CPU.

Each CLI's plot function runs at one state in both packages (the JAX
example loaded from ``examples/``, the port's from ``odil_torch.examples``,
the same seeded fp64 arrays in both states), each in its own directory.
The arrays handed to ``plot_1d``, ``plot_2d``, ``scatter``, ``pcolormesh``
and ``quiver`` are recorded by wrapping both packages' plot functions and
matplotlib's Axes methods, and held to rtol 1e-12; the two runs write the
same file names and ``data_*.pickle`` files with the same keys and values.
``plot_1d`` and ``plot_2d`` draw the same PNG pixels as the JAX package's
at one input; the post-processing scripts and ``compare.py`` against the
JAX scripts; ``core_min``; and a CLI without matplotlib writes its data,
says so once and draws nothing."""

import importlib
import importlib.util
import os
import pickle
import runpy
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import odil_torch as todil  # noqa: E402
from odil_torch import plot as tplot  # noqa: E402
from odil_torch.convert import arrays_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else a


def _arrays(values):
    """The array-like values of a call's arguments, as float64 numpy arrays."""
    out = []
    for v in values:
        v = _host(v)
        if hasattr(v, "shape") and getattr(v, "dtype", None) is not None and np.asarray(v).dtype.kind in "fiu":
            out.append(np.asarray(v, dtype=np.float64))
    return out


@pytest.fixture
def recorder(monkeypatch):
    """Wraps both packages' plot_1d/plot_2d and matplotlib's scatter,
    pcolormesh and quiver: each call appends (name, arrays, scalar kwargs)
    to the list of the package running, then draws."""
    import odil_tpu.plot as jplot

    calls = {"jax": [], "torch": []}
    current = {"key": None}

    def wrap(owner, name):
        orig = getattr(owner, name)

        def fn(*args, **kw):
            scalars = {k: v for k, v in kw.items() if isinstance(v, (str, int, float, bool, type(None)))}
            calls[current["key"]].append((name, _arrays(list(args) + list(kw.values())), scalars))
            return orig(*args, **kw)

        monkeypatch.setattr(owner, name, fn)

    for module in (jplot, tplot):
        wrap(module, "plot_1d")
        wrap(module, "plot_2d")
    for name in ("scatter", "pcolormesh", "quiver"):
        wrap(matplotlib.axes.Axes, name)
    return calls, current


def _jax_example(subdir, name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(ROOT, "examples", subdir,
                                                                                       f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CASES = {
    "veltracer": ("velocity_from_tracer", "plot_func", ["--Nt", "8", "--Nx", "8", "--Ny", "8"]),
    "wave": ("wave", "plot_func", ["--Nt", "16", "--Nx", "16", "--plot_title", "1", "--plotext", "png"]),
    "heat": ("heat", "plot_func", ["--Nt", "16", "--Nx", "16", "--infer_k", "1", "--imposed", "random", "--nimp",
                                   "20", "--plot_title", "1", "--plotext", "png"]),
    "heat_tmax": ("heat_tmax", "plot_func", ["--Nt", "16", "--Nx", "16"]),
    "infer_constant": ("infer_constant", "plot_func", ["--Nt", "16", "--Nx", "16"]),
    "fields": ("basic", "plot", []),
}


def _run_plot(pkg, module, func, argv, where, arrays=None, epoch=7, frame=3):
    """make_problem and the plot function of one package's CLI in `where`, at
    the given state arrays (None: draw them from a seed): the arrays."""
    os.makedirs(where, exist_ok=True)
    os.chdir(where)
    args = module.parse_args(argv + ["--double", "1"] + (["--device", "cpu"] if pkg == "torch" else []))
    if getattr(args, "Ny", 0) is None:
        args.Ny = args.Nx
    problem, state = module.make_problem(args)
    domain = problem.domain
    if arrays is None:
        rng = np.random.default_rng(11)
        arrays = [0.3 * rng.normal(size=np.shape(a)) for a in domain.arrays_from_state(state)]
    if pkg == "jax":
        import jax.numpy as jnp

        domain.arrays_to_state([jnp.asarray(a) for a in arrays], state)
    else:
        domain.arrays_to_state(arrays_from_numpy(arrays, device="cpu"), state)
    getattr(module, func)(problem, state, epoch, frame, None)
    return arrays


@pytest.mark.parametrize("cli", list(CASES))
def test_plot_functions_match_jax(cli, recorder, tmp_path, monkeypatch):
    calls, current = recorder
    subdir, func, argv = CASES[cli]
    monkeypatch.chdir(tmp_path)
    jmod = _jax_example(subdir, "veltracer" if cli == "veltracer" else "fields" if cli == "fields" else cli)
    tmod = importlib.import_module(f"odil_torch.examples.{cli}")
    current["key"] = "jax"
    arrays = _run_plot("jax", jmod, func, argv, tmp_path / "jax")
    current["key"] = "torch"
    _run_plot("torch", tmod, func, argv, tmp_path / "torch", arrays)
    plt.close("all")
    want, got = calls["jax"], calls["torch"]
    assert [c[0] for c in got] == [c[0] for c in want] and want
    for (name, ga, gk), (_, wa, wk) in zip(got, want):
        assert gk == wk, name
        assert len(ga) == len(wa), name
        for a, b in zip(ga, wa):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * max(1.0, float(np.abs(b).max(initial=0))),
                                       err_msg=name)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        if name.startswith("data_") and name.endswith(".pickle"):
            with open(tmp_path / "jax" / name, "rb") as f:
                wd = pickle.load(f)
            with open(tmp_path / "torch" / name, "rb") as f:
                gd = pickle.load(f)
            assert sorted(gd) == sorted(wd), name
            for k in wd:
                if wd[k] is None or isinstance(wd[k], tuple):
                    assert gd[k] == wd[k] if isinstance(wd[k], tuple) else gd[k] is None, k
                    continue
                np.testing.assert_allclose(np.asarray(gd[k], dtype=np.float64), np.asarray(wd[k], dtype=np.float64),
                                           rtol=RTOL, atol=RTOL, err_msg=k)


def _png(path):
    return plt.imread(path)


@pytest.mark.parametrize("which", ["plot_1d", "plot_2d"])
def test_figures_match_jax_pixel_for_pixel(which, tmp_path):
    import odil_tpu as jodil
    import odil_tpu.plot as jplot

    rng = np.random.default_rng(3)
    if which == "plot_1d":
        jd = jodil.Domain(cshape=(16, 12), dimnames=["t", "x"], dtype=np.float64)
        td = todil.Domain(cshape=(16, 12), dimnames=["t", "x"], dtype=np.float64, device="cpu")
        u = rng.random((16, 12))
        for pkg, d, x in (("jax", jd, u), ("torch", td, torch.as_tensor(u))):
            mod = jplot if pkg == "jax" else tplot
            mod.plot_1d(d, x, x * 0.5, path=str(tmp_path / f"{pkg}.png"), transpose=True, nslices=3, cmap="yellow",
                        title="t", dpi=60)
    else:
        jd = jodil.Domain(cshape=(4, 8, 8), dimnames=["t", "x", "y"], dtype=np.float64)
        td = todil.Domain(cshape=(4, 8, 8), dimnames=["t", "x", "y"], dtype=np.float64, device="cpu")
        uu = rng.random((5, 8, 8))
        for pkg, d, x in (("jax", jd, uu), ("torch", td, torch.as_tensor(uu))):
            mod = jplot if pkg == "jax" else tplot
            mod.plot_2d(d, x, x, np.array([0, 2, 4]), np.array([0.0, 0.5, 1.0]), str(tmp_path / f"{pkg}.png"),
                        cmap="rainbow", dpi=60)
    a, b = _png(tmp_path / "torch.png"), _png(tmp_path / "jax.png")
    assert a.shape == b.shape and np.array_equal(a, b)
    assert tplot.g_colormap_names == jplot.g_colormap_names


def test_plotutil_writes_the_same_files(tmp_path):
    from odil_torch import plotutil as tpu
    from odil_tpu import plotutil as jpu

    for pkg, pu in (("jax", jpu), ("torch", tpu)):
        fig, ax = plt.subplots()
        ax.plot([1, 10, 100], [1e-3, 1e-2, 1], label="line")
        ax.set_yscale("log")
        pu.set_log_ticks(ax.yaxis)
        pu.apply_clip_box(ax, ax.lines)
        pu.savefig(fig, str(tmp_path / pkg), extlist=["png", "svg"])
        pu.savelegend(fig, ax, str(tmp_path / f"{pkg}_legend"), extlist=["png"])
        plt.close(fig)
    for ext in ("png", "svg"):
        with open(tmp_path / f"jax.{ext}", "rb") as f, open(tmp_path / f"torch.{ext}", "rb") as g:
            assert f.read() == g.read(), ext
    assert np.array_equal(_png(tmp_path / "jax_legend.png"), _png(tmp_path / "torch_legend.png"))


def test_post_processing_scripts_match_jax(tmp_path, monkeypatch):
    """The heat and poisson plot_train scripts and poisson's plot_field on
    the same train.csv and data pickle: the same PNG pixels."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    with open("train.csv", "w") as f:
        f.write("epoch,error_u,error_k\n")
        for e in range(0, 50, 5):
            f.write(f"{e},{rng.uniform(1e-3, 1)},{rng.uniform(1e-3, 1)}\n")
    with open("data.pickle", "wb") as f:
        pickle.dump({"u": rng.normal(size=(8, 8)), "ref_u": rng.normal(size=(8, 8))}, f)
    scripts = (("heat", "plot_train", "heat_plot_train", ["--data", "train.csv"]),
               ("poisson", "plot_train", "poisson_plot_train", ["--data", "train.csv"]),
               ("poisson", "plot_field", "poisson_plot_field", ["--data", "data.pickle"]))
    for subdir, script, module, argv in scripts:
        monkeypatch.setattr(sys, "argv", [script, *argv, "--out", f"jax_{module}"])
        runpy.run_path(os.path.join(ROOT, "examples", subdir, f"{script}.py"), run_name="__main__")
        plt.close("all")
        importlib.import_module(f"odil_torch.examples.{module}").main([*argv, "--out", f"torch_{module}"])
        assert np.array_equal(_png(f"jax_{module}.png"), _png(f"torch_{module}.png")), module


def test_compare_matches_jax():
    """compare.py at --n 25 --tmax 2.5 on the CPU: every method's trajectory
    within rtol 1e-9 of the JAX script's (Euler, gradient descent, dense
    Newton, matrix-free Gauss-Newton), the gradient-descent loss too, and the
    script's asserts pass."""
    from odil_torch.examples import compare

    j = runpy.run_path(os.path.join(ROOT, "examples", "compare.py"), run_name="jax_compare")
    got = compare.main(["--n", "25", "--tmax", "2.5", "--device", "cpu"])
    n, dt, u0 = 25, 0.1, np.array([2.0, 0.0])
    want = {"euler": np.asarray(j["forward_euler"](u0, n, dt))[1:]}
    for key, fn in (("gd", "odil_gd"), ("newton", "odil_newton_dense"), ("gn", "odil_gauss_newton_mf")):
        traj, loss = j[fn](u0, n, dt)
        want[key] = np.asarray(traj)
        want["loss_" + key] = loss
    for key in ("euler", "gd", "newton", "gn"):
        np.testing.assert_allclose(_host(got[key]), want[key], rtol=1e-9, atol=1e-9 * np.abs(want[key]).max(),
                                   err_msg=key)
    np.testing.assert_allclose(got["loss_gd"], want["loss_gd"], rtol=1e-9)


def test_core_min_matches_jax():
    import odil_tpu as jodil
    from odil_torch import core_min as tcm
    from odil_tpu import core_min as jcm

    cases = [dict(cshape=(4, 6)), dict(cshape=(5,), lower=-1.0, upper=2.0, dimnames=["t"], dtype=np.float64),
             dict(cshape=(1, 3), dtype=np.float32)]
    for kw in cases:
        a, b = tcm.Domain(**kw), jcm.Domain(**kw)
        assert (a.cshape, a.ndim, a.dimnames, a.dtype) == (b.cshape, b.ndim, b.dimnames, b.dtype)
        for loc in ("c" * a.ndim, "n" * a.ndim):
            for x, y in zip(a.points_1d(*range(a.ndim), loc=loc), b.points_1d(*range(b.ndim), loc=loc)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.points_1d(0), b.points_1d(0))
    # The fallbacks to a source domain, with keywords winning.
    td = todil.Domain(cshape=(8, 4), dimnames=("t", "x"), lower=(0, -1), upper=(1, 1), dtype=np.float64,
                      device="cpu")
    jd = jodil.Domain(cshape=(8, 4), dimnames=("t", "x"), lower=(0, -1), upper=(1, 1), dtype=np.float64)
    for kw in ({}, dict(cshape=(3, 5)), dict(upper=2.0)):
        a, b = tcm.Domain(td, **kw), jcm.Domain(jd, **kw)
        assert (a.cshape, a.dimnames, a.dtype) == (b.cshape, b.dimnames, b.dtype)
        np.testing.assert_array_equal(a.lower, b.lower)
        np.testing.assert_array_equal(a.upper, b.upper)
        for x, y in zip(a.points_1d(), b.points_1d()):
            np.testing.assert_array_equal(x, y)
    m = td.get_minimal()
    assert isinstance(m, tcm.Domain) and m.cshape == (8, 4)
    np.testing.assert_array_equal(m.points_1d("x"), jd.get_minimal().points_1d("x"))


def test_cli_without_matplotlib_writes_its_data(tmp_path, monkeypatch):
    """Where matplotlib does not import, the wave CLI's plot epochs still
    write data_*.pickle, draw nothing and say so once in train.log."""
    from odil_torch import util as tutil
    from odil_torch.examples import wave

    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.delitem(sys.modules, "odil_torch.plot", raising=False)
    monkeypatch.delitem(sys.modules, "odil_torch.plotutil", raising=False)
    monkeypatch.chdir(tmp_path)
    sink = (tutil._log_sink.stream, tutil._log_sink.echo)
    try:
        wave.main(["--Nt", "16", "--Nx", "16", "--epochs", "4", "--plot_every", "2", "--frames", "3",
                   "--optimizer", "adam", "--device", "cpu", "--outdir", str(tmp_path / "out")])
    finally:
        if tutil._log_sink.stream is not sink[0]:
            tutil._log_sink.stream.close()
        tutil._log_sink.stream, tutil._log_sink.echo = sink
    files = sorted(os.listdir(tmp_path / "out"))
    assert [f for f in files if f.startswith("data_")] == ["data_00000.pickle", "data_00001.pickle",
                                                           "data_00002.pickle"]
    assert not [f for f in files if f.endswith((".png", ".pdf"))]
    with open(tmp_path / "out" / "train.log") as f:
        assert f.read().count("matplotlib does not import") == 1
    with open(tmp_path / "out" / "data_00002.pickle", "rb") as f:
        data = pickle.load(f)
    assert sorted(data) == ["cshape", "lower", "ref_u", "ref_ut", "state_u", "state_ut", "upper"]
