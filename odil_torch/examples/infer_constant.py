"""Infer three constants (diffusivity, source, velocity) of an
advection-diffusion equation from snapshots at the initial and final time,
trained through ``util.optimize``.

The port's counterpart of ``examples/infer_constant/infer_constant.py``:
the same flags and defaults (the on-device ``lbfgs``), the physics of
``odil_torch.models.advection``, the ``c_diff``, ``c_src`` and ``c_vel``
columns of the history, and an early stop of the optimizer logged rather
than raised.  The plot epochs draw the JAX example's ``u_<frame>`` figure
where matplotlib imports.

    python -m odil_torch.examples.infer_constant --Nt 64 --Nx 64 --epochs 100 --history_every 20
    python -m odil_torch.examples.infer_constant --Nt 16 --Nx 16 --epochs 60 --device cpu
"""

import argparse

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import advection as model


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--Nt", type=int, default=64, help="Grid size in t")
    parser.add_argument("--Nx", type=int, default=64, help="Grid size in x")
    parser.add_argument("--c_diff", type=float, default=0.01, help="Diffusivity")
    parser.add_argument("--c_src", type=float, default=0.1, help="Uniform source")
    parser.add_argument("--c_vel", type=float, default=0.2, help="Advection velocity")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        frames=3,
        plot_every=50,
        report_every=50,
        history_every=10,
        optimizer="lbfgs",
        multigrid=1,
        double=1,
        outdir="out_infer_constant",
    )
    return parser.parse_args(argv)


def coefficients(problem, state):
    return problem.domain.mod.numpy(problem.domain.field(state, "coeff"))


def report_func(problem, state, epoch, cbinfo):
    printlog("diff={:.5g}, src={:.5g}, vel={:.5g}".format(*coefficients(problem, state)))


def history_func(problem, state, epoch, history, cbinfo):
    coeff = coefficients(problem, state)
    history.append("c_diff", float(coeff[0]))
    history.append("c_src", float(coeff[1]))
    history.append("c_vel", float(coeff[2]))


def plot_func(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    extra = problem.extra
    mod = domain.mod
    state_u = mod.numpy(model.clamp_rows(domain.field(state, "u"), extra, mod))
    coeff = mod.numpy(domain.field(state, "coeff"))
    umax = float(np.max(np.abs(mod.numpy(extra.ref_u))))
    plot = odil.util.plot_module()
    if plot is None:
        return
    import matplotlib.pyplot as plt

    fig = plot.plot_1d(domain, extra.ref_u, state_u, cmap="RdBu_r", nslices=5,
                       title="epoch={:}, diff={:.3g}, src={:.3g}, vel={:.3g}".format(epoch, *coeff), transpose=True,
                       transparent=False, umin=-umax, umax=umax)
    odil.util.plot_module("plotutil").savefig(fig, f"u_{frame:05d}", printf=printlog)
    plt.close(fig)


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    problem, state, extra = model.build(
        nt=args.Nt, nx=args.Nx, dtype=dtype, multigrid=args.multigrid, mg_interp=args.mg_interp, mg_nlvl=args.nlvl,
        device=args.device, args=args,
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
