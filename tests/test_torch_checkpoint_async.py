"""The port's asynchronous checkpointer (``odil_torch.checkpoint.AsyncCheckpointer``)
against the JAX package's Orbax one on the CPU: the same script of saves
and restores gives the same fields, slots and latest step; ``max_to_keep``,
``skip_missing``, a half-written step, a save followed at once by an
in-place update, and an Adam resume from an asynchronous checkpoint
against one from a pickle checkpoint (the rows equal to the bit)."""

import csv
import os

import numpy as np
import pytest
import torch

import odil_torch as todil
from odil_torch.checkpoint import AsyncCheckpointer


def _state(odil, u, a):
    domain = odil.Domain(cshape=(8, 4), dimnames=["x", "y"], dtype=np.float64,
                         **({"device": "cpu"} if odil is todil else {}))
    fields = {"u": odil.Field(u.copy().astype(domain.dtype)), "a": odil.Array(np.asarray(a, dtype=domain.dtype))}
    return domain, domain.init_state(odil.State(fields=fields))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _script(odil, Ckpt, where):
    """The round trip of ``tests/test_io.py:184``: saves at steps 10 (with
    slots) and 20, restores of the latest and of step 10."""
    rng = np.random.RandomState(0)
    u0 = rng.rand(8, 4)
    domain, state = _state(odil, u0, np.arange(3.0))
    ckpt = Ckpt(str(where))
    optstate = {"m": [np.full((8, 4), 0.5, domain.dtype)], "step": np.asarray(7.0)}
    ckpt.save(domain, state, 10, optstate=optstate)
    state.fields["u"].array = domain.cast(u0 * 2)
    ckpt.save(domain, state, 20)
    ckpt.wait()
    _, state2 = _state(odil, np.zeros((8, 4)), np.zeros(3))
    out = {"latest": ckpt.latest_step(), "none": ckpt.restore(domain, state2)}
    out["u20"] = _np(state2.fields["u"].array)
    slots = ckpt.restore(domain, state2, step=10)
    out.update(u10=_np(state2.fields["u"].array), a10=_np(state2.fields["a"].array), m=_np(slots["m"][0]),
               step=float(np.asarray(slots["step"])))
    ckpt.close()
    return out


def test_roundtrip_matches_jax(tmp_path):
    import odil_tpu as jodil
    from odil_tpu.checkpoint import AsyncCheckpointer as JCkpt

    want = _script(jodil, JCkpt, tmp_path / "jax")
    got = _script(todil, AsyncCheckpointer, tmp_path / "torch")
    assert got["latest"] == want["latest"] == 20
    assert got["none"] is None and want["none"] is None
    for k in ("u20", "u10", "a10", "m"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["step"] == want["step"] == 7.0
    assert os.path.isfile(tmp_path / "torch" / "10" / "state.pickle")


def test_step_loads_as_a_pickle_checkpoint(tmp_path):
    """A step's ``state.pickle`` is the pickle layout: ``checkpoint_load``
    reads it and returns its slots."""
    domain, state = _state(todil, np.arange(32.0).reshape(8, 4), [1.0, 2.0, 3.0])
    ckpt = AsyncCheckpointer(tmp_path)
    ckpt.save(domain, state, 3, optstate={"v": [torch.full((8, 4), 2.0)]})
    ckpt.close()
    _, state2 = _state(todil, np.zeros((8, 4)), np.zeros(3))
    slots = todil.checkpoint.checkpoint_load(domain, state2, str(tmp_path / "3" / "state.pickle"))
    np.testing.assert_array_equal(_np(state2.fields["u"].array), np.arange(32.0).reshape(8, 4))
    np.testing.assert_array_equal(slots["v"][0], np.full((8, 4), 2.0))


def test_max_to_keep_and_latest_step(tmp_path):
    """max_to_keep=2 leaves the two newest steps; a step directory still
    being written (``<step>.tmp``) is never the latest; no step: None, and
    restore raises."""
    domain, state = _state(todil, np.zeros((8, 4)), np.zeros(3))
    ckpt = AsyncCheckpointer(tmp_path / "c", max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(RuntimeError, match="No checkpoint"):
        ckpt.restore(domain, state)
    for step in (0, 10, 20, 30, 40):
        state.fields["u"].array = domain.cast(np.full((8, 4), float(step)))
        ckpt.save(domain, state, step)
    ckpt.wait()
    assert sorted(os.listdir(tmp_path / "c")) == ["30", "40"]
    os.makedirs(tmp_path / "c" / "50.tmp")
    assert ckpt.latest_step() == 40
    ckpt.restore(domain, state)
    np.testing.assert_array_equal(_np(state.fields["u"].array), np.full((8, 4), 40.0))
    ckpt.close()


def test_skip_missing(tmp_path):
    domain, state = _state(todil, np.ones((8, 4)), np.zeros(3))
    ckpt = AsyncCheckpointer(tmp_path)
    ckpt.save(domain, todil.State(fields={"u": state.fields["u"]}), 1)
    state.fields["a"].array = domain.cast(np.full(3, 5.0))
    assert ckpt.restore(domain, state) is None
    np.testing.assert_array_equal(_np(state.fields["a"].array), np.full(3, 5.0))
    with pytest.raises(RuntimeError, match="Field a not found"):
        ckpt.restore(domain, state, skip_missing=False)
    ckpt.close()


def test_save_is_not_reached_by_a_later_in_place_update(tmp_path):
    """The snapshot is taken at ``save``: an in-place update of the field and
    of a slot right after it does not reach the saved step."""
    domain, state = _state(todil, np.ones((8, 4)), np.zeros(3))
    slot = torch.full((8, 4), 3.0)
    ckpt = AsyncCheckpointer(tmp_path)
    ckpt.save(domain, state, 5, optstate={"m": [slot]})
    state.fields["u"].array.add_(1.0)
    slot.mul_(2.0)
    slots = ckpt.restore(domain, state)
    np.testing.assert_array_equal(_np(state.fields["u"].array), np.ones((8, 4)))
    np.testing.assert_array_equal(slots["m"][0], np.full((8, 4), 3.0))
    ckpt.close()


def test_a_failed_write_raises_in_the_caller(tmp_path):
    domain, state = _state(todil, np.ones((8, 4)), np.zeros(3))
    ckpt = AsyncCheckpointer(tmp_path / "c")
    os.rmdir(tmp_path / "c")
    (tmp_path / "c").write_text("not a directory")
    ckpt.save(domain, state, 1)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed"):
        ckpt.wait()
    ckpt.close()


def _vt_run(outdir, epochs, fmt="pickle", every=0, resume=None):
    """The veltracer CLI at 8^3 fp64 on the CPU, optionally resumed from a
    checkpoint's fields and Adam slots (``resume``: (kind, path))."""
    from odil_torch.examples import veltracer

    argv = ["--Nx", "8", "--kernel", "xla", "--double", "1", "--plot_every", "0", "--device", "cpu",
            "--epochs", str(epochs), "--history_every", "1", "--checkpoint_every", str(every),
            "--checkpoint_format", fmt, "--outdir", str(outdir)]
    args = veltracer.parse_args(argv)
    args.Nt = args.Ny = args.Nx
    todil.setup_outdir(args)
    problem, state = veltracer.make_problem(args)
    if resume is not None:
        kind, path = resume
        if kind == "pickle":
            problem.resume_opt_state = todil.checkpoint.checkpoint_load(problem.domain, state, path)
        else:
            problem.resume_opt_state = AsyncCheckpointer(path).restore(problem.domain, state)
    callback = todil.make_callback(problem, args)
    todil.optimize(args, args.optimizer, problem, state, callback)
    if callback.cbinfo.orbax is not None:
        callback.cbinfo.orbax.close()
    with open(os.path.join(str(outdir), "train.csv")) as fh:
        return [r for r in csv.DictReader(fh)]


def test_adam_resume_matches_the_pickle_resume(tmp_path, monkeypatch):
    """10 epochs with a checkpoint at epoch 10 in either format, then 10 more
    resumed from it with the Adam slots: the rows of the two resumed runs
    are equal to the bit."""
    import odil_tpu.util as jutil
    from odil_torch import util as tutil

    monkeypatch.chdir(tmp_path)
    saved = [(u._log_sink, u._log_sink.stream, u._log_sink.echo) for u in (tutil, jutil)]
    try:
        rows = {}
        for fmt in ("pickle", "orbax"):
            first = _vt_run(tmp_path / fmt, 10, fmt, every=10)
            path = tmp_path / fmt / ("checkpoint_000010.pickle" if fmt == "pickle" else "checkpoint_orbax")
            rows[fmt] = (first, _vt_run(tmp_path / (fmt + "_resumed"), 10, resume=(fmt, str(path))))
    finally:
        for sink, stream, echo in saved:
            if sink.stream is not stream:
                sink.stream.close()
            sink.stream, sink.echo = stream, echo
    assert sorted(os.listdir(tmp_path / "orbax" / "checkpoint_orbax")) == ["0", "10"]
    values = lambda rs: [{k: v for k, v in r.items() if k not in ("walltime", "memory")} for r in rs]
    assert values(rows["pickle"][0]) == values(rows["orbax"][0])
    assert values(rows["pickle"][1]) == values(rows["orbax"][1])
    assert len(rows["orbax"][1]) == 11
