"""Infer the final time ``tmax`` of a heat equation from one measured
value, trained through ``util.optimize``.

The port's counterpart of ``examples/heat_tmax/heat_tmax.py``: the same
flags and defaults (the on-device ``lbfgs``), the physics of
``odil_torch.models.heat.build_tmax``, the ``tmax`` column of the history,
and an early stop of the optimizer logged rather than raised.  The plot
epochs draw the JAX example's ``u_<frame>`` figure where matplotlib
imports.

    python -m odil_torch.examples.heat_tmax --Nt 64 --Nx 64 --epochs 4000 --history_every 200
    python -m odil_torch.examples.heat_tmax --Nt 16 --Nx 16 --epochs 60 --device cpu
"""

import argparse

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import heat as model


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--Nt", type=int, default=64, help="Grid size in t")
    parser.add_argument("--Nx", type=int, default=64, help="Grid size in x")
    parser.add_argument("--kimp", type=float, default=1)
    parser.add_argument("--tmax_ref", type=float, default=4.5)
    parser.add_argument("--tmax_init", type=float, default=1)
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        frames=4,
        plot_every=1000,
        report_every=1000,
        history_every=200,
        optimizer="lbfgs",
        multigrid=1,
        double=1,
        echo=1,
        outdir="out_heat_tmax",
    )
    return parser.parse_args(argv)


def tmax(problem, state):
    return float(problem.domain.mod.numpy(problem.domain.field(state, "coeff"))[0])


def report_func(problem, state, epoch, cbinfo):
    printlog("tmax={:.5g}".format(tmax(problem, state)))


def history_func(problem, state, epoch, history, cbinfo):
    history.append("tmax", tmax(problem, state))


def plot_func(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    extra = problem.extra
    mod = domain.mod
    ref_u = extra.ref_u
    state_u = mod.numpy(model.clamp_initial_row(domain.field(state, "u"), extra, mod))
    coeff = mod.numpy(domain.field(state, "coeff"))
    ixc = domain.size("x") // 2
    title = "epoch={:}, tmax={:.8g}\nu(pi/2, tmax) / u(pi/2, 0) = {:.5g}".format(
        epoch, coeff[0], state_u[-1, ixc] / state_u[0, ixc]
    )
    plot = odil.util.plot_module()
    if plot is None:
        return
    import matplotlib.pyplot as plt

    fig = plot.plot_1d(domain, ref_u, state_u, cmap="Spectral_r", nslices=5, title=title, transpose=True,
                       transparent=False, interpolation="none", umin=0, umax=float(np.max(ref_u)))
    odil.util.plot_module("plotutil").savefig(fig, f"u_{frame:05d}", printf=printlog)
    plt.close(fig)


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    problem, state, extra = model.build_tmax(
        nt=args.Nt, nx=args.Nx, tmax_ref=args.tmax_ref, tmax_init=args.tmax_init, kimp=args.kimp, dtype=dtype,
        multigrid=args.multigrid, mg_interp=args.mg_interp, mg_nlvl=args.nlvl, device=args.device, args=args,
    )
    return problem, state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, plot_func=plot_func, report_func=report_func,
                                  history_func=history_func)
    try:
        odil.optimize(args, args.optimizer, problem, state, callback)
    except odil.EarlyStopError as e:
        printlog(f"Early stop: {e}")
    return problem, state


if __name__ == "__main__":
    main()
