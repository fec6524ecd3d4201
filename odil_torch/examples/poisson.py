"""Poisson source inversion in an N-dimensional cube (ndim 1..6) with zero
Dirichlet boundary conditions, trained through ``util.optimize``.

The port's counterpart of ``examples/poisson/poisson.py``: the same flags
and defaults, the physics of ``odil_torch.models.poisson``, the
``error_u`` column of the history and the XMF and ``data*.pickle`` dumps
(``--dump_xmf``, ``--dump_data``) at each plot epoch and at the end.
``--mesh`` shards the domain over an in-process mesh of the ``--device``:
without ``--halo`` the GSPMD route (the unsharded evaluation on one card),
with ``--halo 1`` the per-shard route, Gauss-Newton (``--optimizer gn``)
included.

    python -m odil_torch.examples.poisson --N 64 --ref osc --rhs exact --epochs 1000 --history_every 50
    python -m odil_torch.examples.poisson --N 16 --epochs 60 --device cpu
"""

import argparse
import pickle

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import poisson as model
from odil_torch.stencil import struct_to_numpy


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--ndim", type=int, choices=range(1, 7), default=2, help="Space dimension")
    parser.add_argument("--N", type=int, default=32, help="Grid size")
    parser.add_argument("--cellbased", type=int, default=1, help="Cell-based fields")
    parser.add_argument("--dump_xmf", type=int, default=0, help="Dump XMF+RAW files")
    parser.add_argument("--plot", type=int, default=0, help="Dump the reference and rhs as XMF+RAW")
    parser.add_argument("--ref", type=str, default="hat", choices=("hat", "osc"))
    parser.add_argument("--rhs", type=str, default="discrete", choices=("discrete", "exact"))
    parser.add_argument("--osc_k", type=float, default=2, help="Parameter for ref='osc'")
    parser.add_argument("--mgloss", type=int, default=0, help="Multigrid-norm loss terms")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        frames=4,
        report_every=100,
        history_every=10,
        plot_every=100,
        history_full=50,
        optimizer="adam",
        multigrid=1,
        lr=0.005,
        double=1,
        outdir="out_poisson",
    )
    return parser.parse_args(argv)


def dump_field(u, name, path, domain, cellbased):
    axes = tuple(reversed(range(domain.ndim)))
    steps = [domain.step_by_dim(d) for d in range(domain.ndim)]
    odil.write_raw_with_xmf(np.transpose(domain.mod.numpy(u), axes), path, spacing=steps, name=name, cell=cellbased)


def plot_func(problem, state, epoch, frame, cbinfo):
    """The XMF and pickle dumps of the JAX example's plot_func (it draws no
    figure)."""
    domain = problem.domain
    extra = problem.extra
    args = extra.args
    if args.frames == 0 and frame is not None:
        return
    suff = "" if frame is None else f"_{frame:05d}"
    paths = []
    if args.dump_xmf and domain.ndim in (2, 3):
        path = f"u{suff}.xdmf2"
        dump_field(domain.field(state, "u"), "u", path, domain, args.cellbased)
        paths.append(path)
    if args.dump_data:
        path = f"data{suff}.pickle"
        payload = struct_to_numpy(
            domain.mod, dict(x=domain.points(), u=domain.field(state, "u"), ref_u=extra.ref_u, rhs=extra.rhs)
        )
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        paths.append(path)
    printlog(" ".join(paths))


def field_error(domain, extra, state, key):
    du = domain.mod.numpy(domain.field(state, key)) - extra.ref_u
    return float(np.sqrt(np.mean(du**2)))


def history_func(problem, state, epoch, history, cbinfo):
    for key in state.fields:
        history.append("error_" + key, field_error(problem.domain, problem.extra, state, key))


def report_func(problem, state, epoch, cbinfo):
    errs = {k: field_error(problem.domain, problem.extra, state, k) for k in state.fields}
    printlog("error: " + ", ".join(f"{k}:{v:.5g}" for k, v in errs.items()))


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    mesh, partition = odil.util.mesh_from_args(args, ["x", "y", "z", "sx", "sy", "sz"][: args.ndim])
    problem, state, extra = model.build(
        n=args.N, ndim=args.ndim, dtype=dtype, multigrid=args.multigrid, mesh=mesh, partition=partition,
        device=args.device, args=args,
    )
    domain = problem.domain
    if domain.multigrid:
        printlog("multigrid levels:", domain.mg_cshapes)
    if args.plot:
        dump_field(extra.ref_u, "u", "ref_u.xdmf2", domain, args.cellbased)
        dump_field(extra.rhs, "rhs", "rhs.xdmf2", domain, args.cellbased)
    return problem, state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(
        problem, args, plot_func=plot_func, history_func=history_func, report_func=report_func
    )
    odil.util.optimize(args, args.optimizer, problem, state, callback)
    plot_func(problem, state, 0, None, None)
    return problem, state


if __name__ == "__main__":
    main()
