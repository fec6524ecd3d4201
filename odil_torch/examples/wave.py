"""Data assimilation for the wave equation from initial u, u_t and boundary
traces, trained through ``util.optimize``.

The port's counterpart of ``examples/wave/wave.py``: the same flags and
defaults, the physics of ``odil_torch.models.wave``, the ``error_u`` column
of the history, an early stop of the optimizer logged rather than raised,
and the ``done`` file at the end.  Plots and their data dumps are not
written yet (``plot.py`` is not ported); the ``frame`` column still
advances.  The default optimizer is the JAX package's on-device ``lbfgs``
(``optim/lbfgs.py``); ``--optimizer lbfgsb`` takes scipy's L-BFGS-B on the
host.

    python -m odil_torch.examples.wave --epochs 200 --history_every 20
    python -m odil_torch.examples.wave --Nt 32 --Nx 32 --optimizer lbfgsb --epochs 20 --device cpu
"""

import argparse

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import wave as model


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


def u_error(domain, extra, state):
    du = domain.mod.numpy(domain.field(state, "u")) - extra.ref_u
    return float(np.sqrt(np.mean(du**2)))


def history_func(problem, state, epoch, history, cbinfo):
    history.append("error_u", u_error(problem.domain, problem.extra, state))


def report_func(problem, state, epoch, cbinfo):
    printlog(f"error: u:{u_error(problem.domain, problem.extra, state):.5g}")


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    problem, state, extra = model.build(
        nt=args.Nt, nx=args.Nx, dtype=dtype, multigrid=args.multigrid, kernel=args.kernel, device=args.device,
        args=args,
    )
    if problem.domain.multigrid:
        printlog("multigrid levels:", problem.domain.mg_cshapes)
    return problem, state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, history_func=history_func, report_func=report_func)
    try:
        odil.util.optimize(args, args.optimizer, problem, state, callback)
    except odil.EarlyStopError as e:
        printlog(f"Early stop: {e}")
    with open("done", "w"):
        pass
    return problem, state


if __name__ == "__main__":
    main()
