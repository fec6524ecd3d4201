"""Training harness: flag registry, output-dir setup, optimize dispatch, and
the periodic-callback engine (report / history / plot / checkpoint).

PyTorch counterpart of ``odil_tpu/util.py``.  ``optimize_grad`` hands the
optimizer the loss function, the fused loss-and-gradient route where the
operator has one (``Problem.make_loss_grad_fn``: the CUDA kernels on the
card) and the schedule of "task epochs" (epochs where the callback has
work), so stretches of epochs run with no host sync in between.  Tensors
live on the device that ``--device`` names (default ``cuda``); the seeds
go to ``np.random`` and to one ``torch.Generator`` that ``setup_outdir``
returns.  ``newton`` runs ``optimize_newton`` (the sparse Jacobian
solved on the host) and ``gn``/``newton_mf`` the matrix-free Gauss-Newton
of ``newton.py``.  ``--checkpoint_format orbax`` keeps the JAX package's
flag and writes asynchronous checkpoints (``checkpoint.AsyncCheckpointer``,
one directory a step under ``checkpoint_orbax``), not Orbax's files: Orbax
imports JAX, which the port never does.
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .history import History
from .optim import make_optimizer

__all__ = [
    "Timer", "add_arguments", "assert_equal", "compute_task_epochs", "get_device_memory_usage_kb", "get_env_config",
    "get_error", "get_memory_usage_kb", "make_callback", "mesh_from_args", "optimize", "optimize_grad",
    "optimize_newton", "plot_module", "printlog", "set_log_file", "setup_outdir",
]


class _LogSink:
    """Destination of :func:`printlog`: a primary stream, optionally echoed
    to stderr when the primary stream is a file (``--echo``)."""

    def __init__(self):
        self.stream = sys.stderr
        self.echo = False
        self.told_no_plots = None  # the stream already told that no figure is drawn

    def emit(self, text):
        if self.echo and self.stream is not sys.stderr:
            sys.stderr.write(text)
            sys.stderr.flush()
        self.stream.write(text)
        self.stream.flush()


_log_sink = _LogSink()


def mesh_from_args(args, dimnames):
    """The (mesh, partition) of ``--mesh`` over the grid's ``dimnames``, or
    (None, None) without it.  Every shard sits on the one device of
    ``--device``: the port's mesh is in-process, and several cards are not
    ported."""
    if not getattr(args, "mesh", None):
        return None, None
    from . import parallel

    sizes = [int(p.partition(":")[2] or 1) for p in args.mesh.split(",")]
    devices = [torch.device(args.device)] * max(1, math.prod(s for s in sizes if s > 0))
    mesh = parallel.mesh_from_spec(args.mesh, devices=devices)
    partition = parallel.auto_partition(dimnames, mesh)
    printlog(f"mesh: {dict(mesh.shape)}, partition: {partition}")
    return mesh, partition


def plot_module(name="plot"):
    """``odil_torch.plot`` (or ``plotutil``) where matplotlib imports, else
    None: a plot epoch then writes its data and draws no figure, and the
    first such epoch of a log says so in it.  Any other import error
    raises."""
    import importlib

    try:
        return importlib.import_module(f"odil_torch.{name}")
    except ImportError as e:
        if not (e.name or "").startswith("matplotlib"):
            raise
        if _log_sink.told_no_plots is not _log_sink.stream:
            _log_sink.told_no_plots = _log_sink.stream
            printlog(f"plots: matplotlib does not import ({e}); the plot epochs write their data and no figures")
        return None


def assert_equal(first, second, msg=""):
    if not first == second:
        raise ValueError(f"mismatch: {first!r} != {second!r}{msg}")


def set_log_file(f=None, echo=None):
    """Redirects :func:`printlog` (reference contract ``util.set_log_file``);
    either argument may be omitted to leave it unchanged."""
    if f is not None:
        _log_sink.stream = f
    if echo is not None:
        _log_sink.echo = echo


def printlog(*msg):
    _log_sink.emit(" ".join(str(m) for m in msg) + "\n")


class Timer:
    """Nested wall-clock accumulator: ``push()`` opens a span, ``pop()``
    closes the innermost open span and adds its duration to
    ``counters[label]``.  The label may be given at either end (or both, in
    which case they must agree)."""

    def __init__(self):
        self.counters = {}
        self._open = []

    def push(self, key=None):
        self._open.append((key, time.perf_counter()))

    def pop(self, key=None):
        opened_as, t0 = self._open.pop()
        if opened_as is not None and key is not None and opened_as != key:
            raise ValueError(f"Timer span opened as {opened_as!r}, closed as {key!r}")
        label = key if opened_as is None else opened_as
        self.counters[label] = self.counters.get(label, 0.0) + (time.perf_counter() - t0)

    def append(self, timer):
        for label, dt in timer.counters.items():
            self.counters[label] = self.counters.get(label, 0.0) + dt


def get_error(u, v):
    diff = np.asarray(u) - np.asarray(v)
    return np.mean(abs(diff)), np.sqrt(np.mean(diff**2)), np.max(abs(diff))


# ---------------------------------------------------------------------------
# Flags.
# ---------------------------------------------------------------------------


def add_arguments(parser):
    """Registers the standard training/output flags: the JAX package's
    (``odil_tpu/util.py:96``, same names and defaults) and ``--device``."""
    add = parser.add_argument
    add("--epochs", type=int, default=None, help="Maximum epochs, defaults to plot_every * frames")
    add("--every_factor", type=float, default=1, help="Multiplier for all *_every options")
    add("--plot_every", type=int, default=5, help="Epochs between plots")
    add("--report_every", type=int, default=10, help="Epochs between reports to stdout")
    add("--history_every", type=int, default=1, help="Epochs between history entries")
    add("--checkpoint_every", type=int, default=0, help="Epochs between checkpoints")
    add(
        "--checkpoint_format",
        type=str,
        default="pickle",
        choices=["pickle", "orbax"],
        help="Checkpoint backend: the reference-compatible pickle, or 'orbax' (the JAX package's name): "
        "asynchronous checkpoints under checkpoint_orbax/<epoch>/state.pickle (pickle files, not Orbax's, "
        "which would need JAX)",
    )
    add("--frames", type=int, default=10, help="Frames to plot. Zero disables first frame.")
    add("--outdir", type=str, default=".", help="Output directory")
    add("--optimizer", type=str, default="adamn", help="Optimizer")
    add("--seed", default=1000, type=int, help="Seed for numpy.random and the torch.Generator")
    add("--plot_title", type=int, default=0, help="Enable title in plots")
    add("--plotext", type=str, default="pdf", help="Extension of plots")
    add("--history_full", type=int, default=0, help="Number of initial epochs with history at every epoch")
    add("--montage", type=int, default=1, help="Run montage after plotting")
    add("--double", type=int, default=None, help="Double precision. Defaults to runtime.dtype")
    add("--echo", type=int, default=0, help="Echo log to stderr")
    add("--epoch_start", type=int, default=0, help="Initial value of epoch")
    add("--frame_start", type=int, default=0, help="Initial value of frame")
    add("--checkpoint", type=str, help="Continue from checkpoint in state_*.pickle")
    add(
        "--checkpoint_train",
        type=str,
        help="Continue from history in state_*_train.pickle; inferred from --checkpoint by default",
    )
    add("--callback_update_state", type=int, default=0, help="Update state after callback")
    add("--bfgs_m", type=int, default=50, help="History size for L-BFGS")
    add("--bfgs_maxls", type=int, default=50, help="Max evaluations in line search")
    add("--bfgs_pgtol", type=float, default=None, help="Convergence tolerance for L-BFGS")
    add("--adam_epsilon", type=float, help="Parameter epsilon in Adam")
    add("--adam_beta_1", type=float, help="Parameter beta_1 in Adam")
    add("--adam_beta_2", type=float, help="Parameter beta_2 in Adam")
    add(
        "--adam_slot_dtype",
        type=str,
        default=None,
        choices=["bfloat16", "float32"],
        help="Storage dtype for Adam moment slots (bfloat16 halves their memory traffic)",
    )
    add("--multigrid", type=int, default=0, help="Use multigrid decomposition")
    add(
        "--mg_interp",
        type=str,
        default="stack",
        choices=["conv", "stack"],
        help="Multigrid interpolation method",
    )
    add("--dump_data", type=int, default=1, help="Dump data_*.pickle with every plot")
    add("--nn_initializer", type=str, default="legacy", choices=["legacy", "glorot", "lecun", "he"])
    add("--max_chunk", type=int, default=512, help="Max epochs per device chunk (epochs between host syncs)")
    add("--mesh", type=str, default=None, help="Device mesh spec, e.g. 't:2,x:2' (dim:size pairs)")
    add("--halo", type=int, default=0, help="Evaluate the loss per shard with explicit halo exchange (requires --mesh)")
    add("--halo_fuse", type=str, default=None, choices=["generic", "mg"], help="Per-shard one-pass route under --halo: generic (default) or mg (reconstruction inside the kernel)")
    add("--profile_dir", type=str, default=None, help="Write a torch.profiler trace of the optimizer run into this dir")
    add("--device", type=str, default="cuda", help="Device of the tensors: cuda (the card) or cpu")
    # Reference flags kept for CLI compatibility (consumed by examples).
    add("--jac_nsmp0", type=int, default=50, help=argparse.SUPPRESS)
    add("--jac_nsmp1", type=int, default=1, help=argparse.SUPPRESS)
    add("--jac_factor", type=float, default=1, help=argparse.SUPPRESS)
    add("--jac_epsilon", type=float, default=1e-8, help=argparse.SUPPRESS)


# ---------------------------------------------------------------------------
# Optimization drivers.
# ---------------------------------------------------------------------------


def _pinfo_from(loss, terms, names, norms):
    return {"terms": terms, "names": names, "norms": norms, "loss": loss}


def compute_task_epochs(args, epoch_start, epochs):
    """Absolute epochs in (epoch_start, epoch_start+epochs] where the
    callback engine has work to do (mirrors the gating in make_callback)."""
    cadences = []
    for name in ("report_every", "history_every", "plot_every", "checkpoint_every"):
        v = getattr(args, name, 0)
        if v:
            cadences.append(v)
    history_full = getattr(args, "history_full", 0) or 0
    out = set()
    for e in range(epoch_start + 1, epoch_start + epochs + 1):
        if e < history_full and getattr(args, "history_every", 0):
            out.add(e)
        for c in cadences:
            if e % c == 0:
                out.add(e)
    out.add(epoch_start + epochs)  # Always sync at the end.
    return sorted(out)


def _profiler(profile_dir, device):
    """A started torch.profiler session (the card's kernels too on cuda), or
    None."""
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def optimize_grad(args, optname, problem, state, callback=None, **kwargs):
    """Gradient-based optimization of `problem` over `state` (in place)."""
    domain = problem.domain

    def loss_grad(arrays):
        domain.arrays_to_state(arrays, state)
        loss, grads, terms, names, norms = problem.eval_loss_grad(state)
        return loss, grads, _pinfo_from(loss, terms, names, norms)

    def callback_wrap(arrays, epoch, pinfo):
        domain.arrays_to_state(arrays, state)
        callback(state, epoch, pinfo)
        if getattr(args, "callback_update_state", 0):
            new = domain.arrays_from_state(state)
            for i in range(len(new)):
                arrays[i] = new[i]

    for flag, key in (
        ("bfgs_m", "m"),
        ("bfgs_pgtol", "pgtol"),
        ("bfgs_maxls", "maxls"),
        ("adam_epsilon", "epsilon"),
        ("adam_beta_1", "beta_1"),
        ("adam_beta_2", "beta_2"),
    ):
        v = getattr(args, flag, None)
        if v is not None:
            kwargs[key] = v
    if getattr(args, "adam_slot_dtype", None):
        kwargs["slot_dtype"] = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.adam_slot_dtype]

    opt = make_optimizer(optname, dtype=domain.dtype, mod=domain.mod, **kwargs)
    printlog(f"Running {opt.displayname} optimizer")
    # Expose the active optimizer so checkpoints can include slot state, and
    # resume slot state loaded by the caller (problem.resume_opt_state).
    problem._active_optimizer = opt
    resume_slots = getattr(problem, "resume_opt_state", None)
    if resume_slots is not None:
        kwargs["init_slots"] = resume_slots
        printlog("Resuming optimizer slot state from checkpoint")

    # Initial evaluation, reported through the callback at epoch_start.
    halo = bool(getattr(args, "halo", 0))
    loss_fn, arrays = problem.make_loss_fn(state, halo=halo)
    loss, grads, terms, names, norms = problem.eval_loss_grad(state)
    pinfo = _pinfo_from(loss, terms, names, norms)
    if callback:
        callback(state, args.epoch_start, pinfo)

    # Callback schedule: dense if the callback needs every epoch.
    every_epoch = getattr(callback, "every_epoch", callback is not None and not hasattr(callback, "cbinfo"))
    if getattr(args, "callback_update_state", 0):
        every_epoch = True
    epochs = args.epochs - args.epoch_start
    task_epochs = None if every_epoch else compute_task_epochs(args, args.epoch_start, epochs)
    # The fused loss+grad route (the CUDA kernels on the card) where the
    # operator has one; None leaves the optimizer to autograd of loss_fn.
    loss_grad_fn = problem.make_loss_grad_fn(state, halo=halo, halo_fuse=getattr(args, "halo_fuse", None))
    opt.bind(
        loss_fn,
        tracers=problem.tracers,
        task_epochs=task_epochs,
        names=names,
        max_chunk=getattr(args, "max_chunk", 512) or 512,
        loss_grad_fn=loss_grad_fn,
    )

    profile_dir = getattr(args, "profile_dir", None)
    prof = _profiler(profile_dir, domain.device)
    try:
        arrays, optinfo = opt.run(
            arrays,
            loss_grad=loss_grad,
            epochs=epochs,
            callback=callback_wrap if callback else None,
            epoch_start=args.epoch_start,
            lr=args.lr,
            **kwargs,
        )
    finally:
        if prof is not None:
            if domain.device.type == "cuda":
                torch.cuda.synchronize(domain.device)
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            printlog(f"profiler trace written to {profile_dir}")
    domain.arrays_to_state(arrays, state)
    return arrays, optinfo


def optimize_newton(args, problem, state, callback=None, **kwargs):
    """Newton's method (``odil_tpu/util.py:297``): each epoch linearizes the
    operator (``Problem.linearize``: gradients on the device, the sparse
    Jacobian assembled on the host), solves for the update on the host in
    float64 (``linsolver.solve`` with ``--linsolver``) and adds it to the
    packed state there, in float64, before casting back to the domain's
    dtype on its device.  See newton.py for the matrix-free Gauss-Newton.

    Sets ``problem.solver_stats``: epochs and the seconds of the
    linearization's gradients, the assembly, the solve and the update,
    summed over the run."""
    from .linsolver import solve

    domain = problem.domain

    def eval_pinfo(state):
        loss, _, terms, names, norms = problem.eval_loss_grad(state)
        return _pinfo_from(loss, terms, names, norms)

    printlog("Running Newton optimizer")
    pinfo = eval_pinfo(state)
    if callback:
        callback(state, args.epoch_start, pinfo)

    stats = problem.solver_stats = dict.fromkeys(("epochs", "gradients_s", "assembly_s", "solve_s", "update_s"), 0)
    evals = 0
    for epoch in range(args.epoch_start, args.epochs):
        vector, matrix = problem.linearize(state)
        evals += 1
        linstatus = dict()
        t_start = time.perf_counter()
        delta = solve(matrix, -vector, args, linstatus, args.linsolver)
        t_solved = time.perf_counter()
        if getattr(args, "linsolver_verbose", 0):
            printlog(linstatus)
        packed = domain.pack_state(state).detach().cpu().numpy()
        domain.unpack_state(domain.mod.cast(packed + delta, domain.dtype), state)
        if domain.device.type == "cuda":
            torch.cuda.synchronize(domain.device)
        stats["epochs"] += 1
        stats["gradients_s"] += problem.linearize_seconds[0]
        stats["assembly_s"] += problem.linearize_seconds[1]
        stats["solve_s"] += t_solved - t_start
        stats["update_s"] += time.perf_counter() - t_solved
        if callback:
            pinfo = eval_pinfo(state)
            pinfo["linsolver"] = linstatus
            callback(state, epoch + 1, pinfo)
    arrays = domain.arrays_from_state(state)
    return arrays, argparse.Namespace(epochs=args.epochs, evals=evals)


def optimize(args, optname, problem, state, callback=None, **kwargs):
    """Runs the optimizer `optname`: ``newton`` (``optimize_newton``),
    ``gn`` or ``newton_mf`` (``newton.optimize_gauss_newton``), else a
    gradient-based optimizer of the registry (``optimize_grad``)."""
    if optname == "newton":
        return optimize_newton(args, problem, state, callback, **kwargs)
    if optname in ("gn", "newton_mf"):
        from .newton import optimize_gauss_newton

        return optimize_gauss_newton(args, problem, state, callback, **kwargs)
    return optimize_grad(args, optname, problem, state, callback, **kwargs)


# ---------------------------------------------------------------------------
# Environment / output dir.
# ---------------------------------------------------------------------------


def get_memory_usage_kb():
    try:
        import psutil

        return psutil.Process().memory_info().rss // 1024
    except ImportError:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0


def get_device_memory_usage_kb(device=None):
    """(allocated, reserved) bytes of the card's caching allocator in KiB;
    zeros for the CPU.  device: default the current card once CUDA is in
    use, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return 0, 0
    return torch.cuda.memory_allocated(device) // 1024, torch.cuda.memory_reserved(device) // 1024


def get_env_config():
    keys = ["ODIL_WARN", "ODIL_DTYPE", "CUDA_VISIBLE_DEVICES"]
    return {k: os.environ.get(k, "") for k in keys}


def setup_outdir(args, relpath_args=None):
    """Creates the output dir, writes args.json, chdirs, opens train.log,
    rescales *_every by every_factor and seeds ``np.random``.  Returns a
    ``torch.Generator`` on ``args.device`` seeded with ``args.seed`` (None
    without a seed) for the caller's random draws; the global torch seed is
    left alone."""
    from . import runtime

    device = getattr(args, "device", "cuda")
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "args.json"), "w") as f:
        record = dict(
            vars(args),
            **get_env_config(),
            runtime_backend="torch",
            runtime_dtype=runtime.default_dtype().name,
            torch_version=torch.__version__,
        )
        json.dump(record, f, sort_keys=True, indent=4, default=str)

    os.chdir(outdir)
    set_log_file(open("train.log", "w"), echo=args.echo)

    for k in relpath_args or []:
        if getattr(args, k, None):
            setattr(args, k, os.path.relpath(getattr(args, k), start=outdir))

    def scaled(v):
        # 0 means "disabled" (as in the cadence gates); only scale active ones.
        if not v:
            return v
        return max(1, round(v * args.every_factor))

    args.plot_every = scaled(args.plot_every)
    args.history_every = scaled(args.history_every)
    args.report_every = scaled(args.report_every)
    if args.epochs is None:
        args.epochs = args.frames * args.plot_every

    generator = None
    if args.seed is not None:
        np.random.seed(args.seed)
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
    printlog(" ".join(sys.argv))
    return generator


# ---------------------------------------------------------------------------
# Callback engine.
# ---------------------------------------------------------------------------


def make_callback(
    problem,
    args=None,
    epoch_func=None,
    report_func=None,
    history_func=None,
    checkpoint_func=None,
    plot_func=None,
):
    """Builds the periodic callback: report / history / plot / checkpoint
    gated by the *_every cadences (reference ``util.py:337-467``)."""
    cbinfo = argparse.Namespace()
    cbinfo.walltime = 0
    cbinfo.epoch = 0
    cbinfo.time_callback = 0
    cbinfo.time_start = time.time()
    cbinfo.problem = problem
    cbinfo.args = args
    cbinfo.frame = getattr(args, "frame_start", 0) or 0
    cbinfo.history = History(csvpath="train.csv", warmup=1) if args.history_every else None
    cbinfo.orbax = None  # the AsyncCheckpointer of --checkpoint_format orbax, made at the first checkpoint

    def callback(state, epoch, pinfo):
        problem = cbinfo.problem
        domain = problem.domain
        args = cbinfo.args
        history = cbinfo.history
        time_prev = time.time()

        cbinfo.task_report = args.report_every and epoch % args.report_every == 0
        cbinfo.task_history = history is not None and (
            epoch % args.history_every == 0 or epoch < args.history_full
        )
        cbinfo.task_plot = args.plot_every and epoch % args.plot_every == 0 and (epoch or args.frames)
        cbinfo.task_checkpoint = args.checkpoint_every and epoch % args.checkpoint_every == 0
        cbinfo.pinfo = pinfo

        # Keep the host-visible tracer in sync for host-driven paths
        # (eval_loss_grad, eval_operator); the device loop sets its own epoch.
        if isinstance(problem.tracers, dict):
            problem.tracers["epoch"] = epoch
        if epoch_func is not None:
            epoch_func(problem, state, epoch, cbinfo)

        curtime = time.time()
        cbinfo.time_callback += curtime - time_prev
        time_prev = curtime
        walltime = curtime - cbinfo.time_start - cbinfo.time_callback

        if cbinfo.task_report:
            printlog(f"\nepoch={epoch:05d}")
            if pinfo and "norms" in pinfo:
                norms, names = pinfo["norms"], pinfo["names"]
                printlog(
                    "residual: "
                    + ", ".join(
                        "{}:{:.5g}".format(name or str(i), np.asarray(norm))
                        for i, (norm, name) in enumerate(zip(norms, names))
                    )
                )
            if report_func is not None:
                report_func(problem, state, epoch, cbinfo)
            cpu_used = get_memory_usage_kb()
            dev_used, dev_pool = get_device_memory_usage_kb(domain.device)
            printlog(
                f"memory: {cpu_used // 1024} MiB, device_used: {dev_used // 1024} MiB, "
                f"device_pool: {dev_pool // 1024} MiB"
            )
            if epoch > cbinfo.epoch:
                wte = (walltime - cbinfo.walltime) / (epoch - cbinfo.epoch)
                thr = math.prod(domain.cshape) / wte if wte > 0 else 0
            else:
                wte, thr = 0, 0
            printlog(
                f"walltime: {walltime:.3f} s"
                + f", walltime+callback: {walltime + cbinfo.time_callback:.3f} s"
                + f", walltime/epoch: {wte * 1000:.3f} ms"
            )
            printlog(f"throughput: {thr / 1e6:.3f} Mcells/s")
            cbinfo.walltime = walltime
            cbinfo.epoch = epoch

        if cbinfo.task_history:
            cpu_used = get_memory_usage_kb()
            dev_used, dev_pool = get_device_memory_usage_kb(domain.device)
            history.append("epoch", epoch)
            history.append("frame", cbinfo.frame)
            if pinfo and "norms" in pinfo:
                for i, (norm, name) in enumerate(zip(pinfo["norms"], pinfo["names"])):
                    history.append("norm_{}".format(name or str(i)), np.asarray(norm))
            if pinfo and "loss" in pinfo:
                history.append("loss", float(pinfo["loss"]))
            if getattr(args, "linsolver_history", 0) and "linsolver" in pinfo:
                for key, val in pinfo["linsolver"].items():
                    if isinstance(val, (int, float, str, np.floating)):
                        history.append("lin_" + key, val)
            history.append("walltime", np.round(walltime, 3))
            history.append("memory", cpu_used // 1024)
            history.append("gpu_used", dev_used // 1024)
            history.append("gpu_pool", dev_pool // 1024)
            if history_func is not None:
                history_func(problem, state, epoch, history, cbinfo)
            history.write()

        if cbinfo.task_plot:
            if plot_func is not None:
                plot_func(problem, state, epoch, cbinfo.frame, cbinfo)
            cbinfo.frame += 1

        if cbinfo.task_checkpoint:
            if checkpoint_func is not None:
                checkpoint_func(problem, state, epoch, cbinfo)
            else:
                opt = getattr(problem, "_active_optimizer", None)
                optstate = getattr(opt, "slots", None) if opt is not None else None
                if getattr(args, "checkpoint_format", "pickle") == "orbax":
                    if cbinfo.orbax is None:
                        import atexit

                        from .checkpoint import AsyncCheckpointer

                        cbinfo.orbax = AsyncCheckpointer("checkpoint_orbax")
                        atexit.register(cbinfo.orbax.close)
                    printlog(f"checkpoint_orbax/{epoch}")
                    cbinfo.orbax.save(problem.domain, state, epoch, optstate=optstate)
                else:
                    from .checkpoint import checkpoint_save

                    path = f"checkpoint_{epoch:06d}.pickle"
                    printlog(path)
                    checkpoint_save(problem.domain, state, path, optstate=optstate)

        cbinfo.time_callback += time.time() - time_prev

    callback.cbinfo = cbinfo
    callback.every_epoch = epoch_func is not None
    return callback
