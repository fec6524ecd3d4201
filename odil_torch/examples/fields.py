"""Fields with values at cell centers, faces and nodes, fitted to a linear
target under multigrid, trained through ``util.optimize_grad``.

The port's counterpart of ``examples/basic/fields.py``: four fields at the
locations ``cc``, ``nn``, ``nc`` and ``cn`` and a neural net in the state
(its weights drawn from a ``torch.Generator`` seeded with ``--seed``; the
operator does not use it).  The plot of the staggered layout is not drawn
yet (``plot.py`` is not ported); the ``frame`` column still advances.

    python -m odil_torch.examples.fields --plot 0 --epochs 100 --history_every 10
    python -m odil_torch.examples.fields --plot 0 --epochs 60 --device cpu
"""

import argparse

import numpy as np
import torch

import odil_torch as odil

LOCS = (("uc", "cc"), ("un", "nn"), ("ufx", "nc"), ("ufy", "cn"))


def target(x, y):
    return x * 0.25 + y * 0.5


def operator(ctx):
    res = []
    for key, loc in LOCS:
        x, y = ctx.points(loc=loc)
        res += [(key, ctx.field(key) - target(x, y))]
    return res


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--Nx", type=int, default=8, help="Grid size in x")
    parser.add_argument("--Ny", type=int, default=4, help="Grid size in y")
    parser.add_argument("--plot", type=int, default=1, help="Plot fields (not drawn by the port yet)")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        outdir="out_fields",
        echo=1,
        frames=1,
        plot_every=100,
        report_every=50,
        history_every=10,
        optimizer="adam",
        lr=1e-2,
        multigrid=1,
    )
    return parser.parse_args(argv)


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    domain = odil.Domain(
        cshape=(args.Nx, args.Ny),
        dimnames=["x", "y"],
        lower=(0, 0),
        upper=(2, 1),
        dtype=dtype,
        multigrid=args.multigrid,
        mg_interp=args.mg_interp,
        mg_nlvl=args.nlvl,
        device=args.device,
    )
    fields = {key: odil.Field(np.zeros(domain.size(loc=loc)), loc=loc) for key, loc in LOCS}
    fields["net"] = domain.make_neural_net([2, 4, 2], torch.Generator().manual_seed(args.seed))
    state = domain.init_state(odil.State(fields=fields))
    return odil.Problem(operator, domain), state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args)
    odil.util.optimize_grad(args, args.optimizer, problem, state, callback)
    return problem, state


if __name__ == "__main__":
    main()
