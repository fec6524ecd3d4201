"""Data assimilation for the wave equation from initial u, u_t and boundary
traces, trained through ``util.optimize``.

The port's counterpart of ``examples/wave/wave.py``: the same flags and
defaults, the physics of ``odil_torch.models.wave``, the ``error_u`` column
of the history, an early stop of the optimizer logged rather than raised,
and the ``done`` file at the end.  The plot epochs write the JAX example's
``data_<frame>.pickle`` (``--dump_data``) and, where matplotlib imports,
its ``u_`` and ``ut_`` figures.  ``--mesh t:4 --halo 1`` evaluates the loss
per shard on an in-process mesh of the ``--device`` (the t axis only: the
row model reads its walls from the plane's index); ``--mesh`` without
``--halo`` takes the GSPMD route, the unsharded evaluation on the card.
The default optimizer is the JAX package's on-device ``lbfgs``
(``optim/lbfgs.py``); ``--optimizer lbfgsb`` takes scipy's L-BFGS-B on the
host.

    python -m odil_torch.examples.wave --epochs 200 --history_every 20
    python -m odil_torch.examples.wave --Nt 32 --Nx 32 --optimizer lbfgsb --epochs 20 --device cpu
"""

import argparse
import pickle

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import wave as model
from odil_torch.stencil import extrap_quad, extrap_quadh, struct_to_numpy


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--kernel", type=str, default="xla", choices=["xla", "pallas"],
                        help="Residual evaluation path: the plain operator or the row-wise kernels")
    parser.add_argument("--Nt", type=int, default=64, help="Grid size in t")
    parser.add_argument("--Nx", type=int, default=64, help="Grid size in x")
    parser.add_argument("--kimp", type=float, default=1, help="Initial-condition weight")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        double=1,
        multigrid=1,
        outdir="out_wave",
        linsolver="direct",
        optimizer="lbfgs",
        lr=0.001,
        plotext="png",
        plot_title=1,
        plot_every=100,
        report_every=10,
        history_full=5,
        history_every=10,
        frames=2,
    )
    return parser.parse_args(argv)


def derived_ut(domain, init_u, uu):
    """Central-difference time derivative of the recovered field (numpy)."""
    dt = domain.step("t")
    u = np.asarray(uu)
    utm = np.roll(u, 1, axis=0)
    utp = np.roll(u, -1, axis=0)
    utm[0, :] = extrap_quadh(utp[0, :], u[0, :], domain.mod.numpy(init_u))
    utp[-1, :] = extrap_quad(u[-3, :], u[-2, :], u[-1, :])
    return (utp - utm) / (2 * float(dt))


def plot_func(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    extra = problem.extra
    args = extra.args
    path0 = f"u_{frame:05d}.{args.plotext}"
    path1 = f"ut_{frame:05d}.{args.plotext}"
    printlog(path0, path1)

    state_u = domain.mod.numpy(domain.field(state, "u"))
    state_ut = derived_ut(domain, extra.init_u, state_u)

    if args.dump_data:
        payload = struct_to_numpy(
            domain.mod,
            dict(upper=domain.upper, lower=domain.lower, cshape=domain.cshape, state_u=state_u, state_ut=state_ut,
                 ref_u=extra.ref_u, ref_ut=extra.ref_ut),
        )
        with open(f"data_{frame:05d}.pickle", "wb") as f:
            pickle.dump(payload, f)

    plot = odil.util.plot_module()
    if plot is None:
        return
    for data, ref, path, label in ((state_u, extra.ref_u, path0, "u"), (state_ut, extra.ref_ut, path1, "ut")):
        umax = np.max(np.abs(ref))
        plot.plot_1d(domain, ref, data, path=path, title=f"{label} epoch={epoch:05d}" if args.plot_title else None,
                     cmap="RdBu_r", nslices=5, transpose=True, umin=-umax, umax=umax)


def u_error(domain, extra, state):
    du = domain.mod.numpy(domain.field(state, "u")) - extra.ref_u
    return float(np.sqrt(np.mean(du**2)))


def history_func(problem, state, epoch, history, cbinfo):
    history.append("error_u", u_error(problem.domain, problem.extra, state))


def report_func(problem, state, epoch, cbinfo):
    printlog(f"error: u:{u_error(problem.domain, problem.extra, state):.5g}")


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    mesh, partition = odil.util.mesh_from_args(args, ("t", "x"))
    problem, state, extra = model.build(
        nt=args.Nt, nx=args.Nx, dtype=dtype, multigrid=args.multigrid, kernel=args.kernel, device=args.device,
        mesh=mesh, partition=partition, args=args,
    )
    if problem.domain.multigrid:
        printlog("multigrid levels:", problem.domain.mg_cshapes)
    return problem, state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, plot_func=plot_func, history_func=history_func,
                                  report_func=report_func)
    try:
        odil.util.optimize(args, args.optimizer, problem, state, callback)
    except odil.EarlyStopError as e:
        printlog(f"Early stop: {e}")
    with open("done", "w"):
        pass
    return problem, state


if __name__ == "__main__":
    main()
