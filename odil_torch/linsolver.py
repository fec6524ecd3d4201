"""Sparse linear solvers for the Newton update, on the host in float64.

The port's copy of ``odil_tpu/linsolver.py:22-134`` (NumPy and SciPy only):
``solve`` forms the damped normal equations
(M^T M + damp^2 I + dampdiag^2 diag(M^T M)) x = M^T b and solves them with
the selected method -- ``direct`` (sparse LU), ``directsq`` (LU of M
itself), ``lsqr``, ``cg`` (Jacobi-preconditioned), ``multigrid``/``vcycle``
(CG under the smoothed-aggregation AMG V-cycle of ``amg.py``) or
``bicgstab``.  ``direct_cu`` needs ``cupy`` and ``sparseqr`` the
``sparseqr`` package; neither is a dependency, so both raise at import as
in the JAX package.  ``add_arguments`` registers the flags every example
reads (``--lr`` and ``--nlvl`` among them).
"""

import numpy as np

__all__ = ["solve", "add_arguments"]


def _normal_equations(matr, rhs, args):
    import scipy.sparse

    reg = (matr.T @ matr).tocsr()
    if args.linsolver_damp:
        reg = reg + args.linsolver_damp**2 * scipy.sparse.eye(matr.shape[1], format="csr")
    if args.linsolver_dampdiag:
        reg = reg + args.linsolver_dampdiag**2 * scipy.sparse.diags(reg.diagonal())
    return reg, matr.T @ rhs


def solve(matr, rhs, args, status=None, linsolver="direct"):
    """Solves the least-squares system `matr x ~= rhs`; returns x (numpy).

    The solve always runs in float64: it is host-side regardless, and the
    iterative methods (bicgstab especially) diverge on float32 normal
    equations of ill-conditioned Jacobians.  Callers cast the update back
    to the working dtype."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    if matr.dtype != np.float64:
        matr = matr.astype(np.float64)
    rhs = np.asarray(rhs, dtype=np.float64)
    if status is None:
        status = dict()
    if args.linsolver_maxiter is None:
        args.linsolver_maxiter = 1000 if args.linsolver == "lsqr" else 50

    if linsolver == "direct":
        reg, rhs_reg = _normal_equations(matr, rhs, args)
        return spla.spsolve(reg, rhs_reg, permc_spec="MMD_ATA")
    if linsolver == "directsq":
        return spla.spsolve(matr.tocsr(), rhs, permc_spec="MMD_ATA")
    if linsolver == "lsqr":
        out = spla.lsqr(
            matr,
            rhs,
            damp=args.linsolver_damp,
            atol=args.linsolver_tol,
            btol=args.linsolver_tol,
            iter_lim=args.linsolver_maxiter,
        )
        sol, _, itn, _, _, anorm, acond, arnorm = out[:8]
        status.update(residual=arnorm, anorm=anorm, acond=acond, niter=itn)
        return sol
    if linsolver in ("multigrid", "vcycle", "cg"):
        reg, rhs_reg = _normal_equations(matr, rhs, args)
        if linsolver == "cg":
            # Jacobi-preconditioned CG on the normal equations.
            diag = reg.diagonal()
            diag = np.where(np.abs(diag) > 1e-30, diag, 1.0)
            precond = spla.LinearOperator(reg.shape, matvec=lambda v: v / diag)
        else:
            # Smoothed-aggregation AMG V-cycle preconditioner (amg.py).
            from .amg import build_hierarchy

            hierarchy = build_hierarchy(
                reg,
                theta=0.2,
                cheb_degree=max(1, getattr(args, "smooth_pre", 3)),
                max_coarse=max(getattr(args, "ndirect", 3) ** 2, 64),
            )
            precond = hierarchy.aslinearoperator()
            status["amg_levels"] = hierarchy.nlevels
        residuals = []

        def track(x):
            residuals.append(float(np.sqrt(np.mean((reg @ x - rhs_reg) ** 2))))

        sol, _ = spla.cg(
            reg,
            rhs_reg,
            rtol=args.linsolver_tol,
            atol=args.linsolver_tol,
            maxiter=args.linsolver_maxiter,
            M=precond,
            callback=track,
        )
        status.update(residual=residuals[-1] if residuals else 0.0, niter=len(residuals))
        return sol
    if linsolver == "bicgstab":
        reg, rhs_reg = _normal_equations(matr, rhs, args)
        residuals = []

        def track(x):
            residuals.append(float(np.sqrt(np.mean((reg @ x - rhs_reg) ** 2))))

        sol, _ = spla.bicgstab(
            reg,
            rhs_reg,
            rtol=0,
            atol=args.linsolver_tol,
            callback=track,
            maxiter=args.linsolver_maxiter,
        )
        status.update(residual=residuals[-1] if residuals else 0.0, niter=len(residuals))
        return sol
    if linsolver == "direct_cu":
        import cupy
        import cupyx.scipy.sparse
        import cupyx.scipy.sparse.linalg

        reg, rhs_reg = _normal_equations(matr, rhs, args)
        sol = cupyx.scipy.sparse.linalg.spsolve(
            cupyx.scipy.sparse.csr_matrix(reg), cupy.array(rhs_reg)
        )
        return sol.get()
    if linsolver == "sparseqr":
        import sparseqr

        return sparseqr.solve(matr, rhs, tolerance=args.linsolver_tol)
    raise ValueError("Unknown linsolver=" + linsolver)


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
