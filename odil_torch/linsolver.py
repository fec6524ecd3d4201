"""The linear-solver flags of ``odil_tpu/linsolver.py:137`` (``--lr`` and
``--nlvl`` among them), which every example reads.

The sparse solvers themselves (``solve`` and its menu: multigrid, vcycle,
direct, cg, ...) and the Newton path that calls them are not ported yet
(ROADMAP.md section 1, item 5); the optimizers that need them raise.
"""

__all__ = ["add_arguments"]


def add_arguments(parser):
    add = parser.add_argument
    add(
        "--linsolver",
        type=str,
        choices=["multigrid", "vcycle", "direct", "directsq", "direct_cu", "sparseqr", "lsqr", "lsqr_cu", "bicgstab", "cg"],
        default="direct",
        help="Linear solver for Newton",
    )
    add("--linsolver_maxiter", type=int, default=None, help="Max iterations of linear solver")
    add("--linsolver_tol", type=float, default=1e-6, help="Tolerance for linear solver")
    add("--linsolver_damp", type=float, default=0, help="Levenberg damping (0: none)")
    add("--linsolver_dampdiag", type=float, default=0, help="Diagonal damping multiplier (0: none)")
    add("--linsolver_verbose", type=int, default=0, help="Verbosity of linsolver messages")
    add("--linsolver_precond_every", type=int, default=0,
        help="gn: rebuild the multilevel preconditioner every N epochs "
        "(0: auto -- rebuild when the loss reduction stalls)")
    add("--linsolver_history", type=int, default=0, help="Dump linsolver status to history")
    add("--lr", type=float, default=1e-3, help="Learning rate")
    add("--nlvl", type=int, default=100, help="Multigrid levels")
    add("--smooth_pre", type=int, default=3,
        help="Pre-smoothing steps (vcycle: Chebyshev smoother degree)")
    add("--smooth_post", type=int, default=2, help="Post-smoothing steps")
    add("--omega", type=float, default=0.6, help="Jacobi smoother relaxation factor")
    add("--ndirect", type=int, default=3, help="Direct-solver threshold grid size")
    add("--restriction", type=str, choices=("full", "half", "injection"), default="full")
