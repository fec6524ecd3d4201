"""Infer the final time ``tmax`` of a heat equation from one measured
value, trained through ``util.optimize``.

The port's counterpart of ``examples/heat_tmax/heat_tmax.py``: the same
flags and defaults (the on-device ``lbfgs``), the physics of
``odil_torch.models.heat.build_tmax``, the ``tmax`` column of the history,
and an early stop of the optimizer logged rather than raised.  Plots are
not written yet (``plot.py`` is not ported); the ``frame`` column still
advances.

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
    callback = odil.make_callback(problem, args, report_func=report_func, history_func=history_func)
    try:
        odil.optimize(args, args.optimizer, problem, state, callback)
    except odil.EarlyStopError as e:
        printlog(f"Early stop: {e}")
    return problem, state


if __name__ == "__main__":
    main()
