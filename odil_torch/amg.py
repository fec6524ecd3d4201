"""Host-side smoothed-aggregation algebraic multigrid (SA-AMG): the port's own
copy of ``odil_tpu/amg.py``, NumPy and SciPy only, so it builds the same
hierarchy and applies the same cycle to the bit.

Preconditioner for the Newton normal equations, giving ``--linsolver
multigrid`` genuine multilevel strength.  The reference delegates this to
the external PyAMG package (``src/odil/linsolver.py:61-72``:
``pyamg.smoothed_aggregation_solver(matr_reg)`` with CG acceleration);
this module is a from-scratch implementation of the same construction
so the capability needs no optional dependency:

- strength of connection: symmetric,  |a_ij| >= theta sqrt(|a_ii a_jj|)
- aggregation: greedy (Vanek) over the strength graph, three passes
- tentative prolongator: piecewise-constant over aggregates, normalized
  (near-nullspace B = ones)
- prolongator smoothing: P = (I - omega D^{-1} A) T with
  omega = 4/3 / rho(D^{-1} A), rho from power iteration
- coarse operators: Galerkin  A_c = P^T A P
- cycle: V(1,1) with degree-``cheb_degree`` Chebyshev-Jacobi smoothing
  (symmetric by construction, so the V-cycle is a valid SPD CG
  preconditioner), sparse-LU direct solve on the coarsest level.

Everything here is NumPy/SciPy on the host: the system is already a host
CSR matrix assembled by ``problem.linearize``; the multilevel path on the
device (matrix-free Gauss-Newton with the geometric V-cycle or BPX) lives
in ``newton.py``.
"""

import numpy as np

__all__ = ["AmgHierarchy", "build_hierarchy"]


def _rho_dinv_a(A, diag, iters=12, seed=0):
    """Power-iteration estimate of the spectral radius of D^{-1} A."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x) + 1e-300
    rho = 1.0
    for _ in range(iters):
        y = A @ x / diag
        norm = np.linalg.norm(y)
        if norm == 0.0:
            return 1.0
        rho = norm
        x = y / norm
    return float(rho)


def _strength_graph(A, theta):
    """Symmetric strength-of-connection pattern of a CSR matrix (diagonal
    removed): keep a_ij with |a_ij| >= theta * sqrt(|a_ii a_jj|)."""
    import scipy.sparse

    A = A.tocoo()
    d = np.abs(A.diagonal())
    mask = A.row != A.col
    if theta > 0.0:
        scale = np.sqrt(d[A.row] * d[A.col])
        mask &= np.abs(A.data) >= theta * scale
    S = scipy.sparse.csr_matrix(
        (np.ones(np.count_nonzero(mask)), (A.row[mask], A.col[mask])),
        shape=A.shape,
    )
    return S


def _aggregate(S):
    """Greedy (Vanek) aggregation over the strength graph.

    Returns an int array mapping each node to its aggregate id (nodes with
    no strong neighbors become singletons)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0

    # Pass 1: a node whose whole strong neighborhood is untouched seeds a
    # new aggregate containing itself and all its strong neighbors.
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) == 0:
            continue
        if np.all(agg[nbrs] == -1):
            agg[i] = nagg
            agg[nbrs] = nagg
            nagg += 1

    # Pass 2: remaining nodes join the aggregate of any strong neighbor.
    joined = []
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        for j in nbrs:
            if agg[j] != -1:
                agg[i] = agg[j]
                joined.append(i)
                break
    # (joined nodes should not seed pass-3 aggregates; agg already set)

    # Pass 3: whatever is left forms aggregates from its unaggregated
    # strong neighborhood (isolated nodes become singletons).
    for i in range(n):
        if agg[i] != -1:
            continue
        agg[i] = nagg
        nbrs = indices[indptr[i]:indptr[i + 1]]
        for j in nbrs:
            if agg[j] == -1:
                agg[j] = nagg
        nagg += 1

    return agg, nagg


def _tentative_prolongator(agg, nagg):
    """Piecewise-constant prolongator with unit columns (B = ones)."""
    import scipy.sparse

    n = len(agg)
    counts = np.bincount(agg, minlength=nagg).astype(np.float64)
    data = 1.0 / np.sqrt(counts[agg])
    T = scipy.sparse.csr_matrix((data, (np.arange(n), agg)), shape=(n, nagg))
    return T


class _Level:
    __slots__ = ("A", "P", "diag", "rho", "cheb_coefs")

    def __init__(self, A):
        self.A = A
        self.P = None
        diag = A.diagonal().copy()
        self.diag = np.where(np.abs(diag) > 1e-300, diag, 1.0)
        self.rho = None
        self.cheb_coefs = None


def _chebyshev_coefs(lo, hi, degree):
    """Coefficients of the degree-`degree` Chebyshev polynomial smoother on
    [lo, hi], as the monomial coefficients of p(t) with x <- x + p(A)r.

    Uses the standard recurrence evaluated symbolically in the monomial
    basis (degree <= 4 in practice, so conditioning is fine)."""
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    # Chebyshev on [-1,1]: T_k; shifted argument s(t) = (theta - t)/delta.
    # Smoother: x_{k+1} = x_k + alpha_k r_k built from the three-term
    # recurrence; we instead evaluate the error polynomial coefficients
    # numerically by fitting p at Chebyshev nodes (robust + simple).
    # p is defined by: e_out = q(t) e_in with q(t) = T_d(s(t)) / T_d(s(0)),
    # and p(t) = (1 - q(t)) / t.
    d = degree
    nodes = theta + delta * np.cos(np.pi * (np.arange(d + 1) + 0.5) / (d + 1))
    s0 = theta / delta
    Td_s0 = np.cosh(d * np.arccosh(abs(s0))) * (np.sign(s0) ** (d % 2))
    q = np.cos(d * np.arccos(np.clip((theta - nodes) / delta, -1.0, 1.0))) / Td_s0
    p_vals = (1.0 - q) / nodes
    coefs = np.polyfit(nodes, p_vals, d - 1)
    return coefs  # highest degree first, as np.polyval expects


def _cheb_smooth(level, x, b, coefs):
    """x <- x + p(D^{-1}A) D^{-1} r, the Chebyshev-Jacobi smoother."""
    r = (b - level.A @ x) / level.diag
    acc = coefs[0] * r
    for c in coefs[1:]:
        acc = (level.A @ acc) / level.diag + c * r
    return x + acc


class AmgHierarchy:
    """Smoothed-aggregation hierarchy; ``precond(r)`` applies one V-cycle."""

    def __init__(self, levels, coarse_solve, cheb_degree):
        self.levels = levels
        self._coarse_solve = coarse_solve
        self.cheb_degree = cheb_degree

    @property
    def nlevels(self):
        return len(self.levels)

    def cycle(self, level_index, b):
        """One V(1,1) cycle on level `level_index` with zero initial guess."""
        if level_index == len(self.levels) - 1:
            return self._coarse_solve(b)
        lvl = self.levels[level_index]
        x = _cheb_smooth(lvl, np.zeros_like(b), b, lvl.cheb_coefs)
        r = b - lvl.A @ x
        xc = self.cycle(level_index + 1, lvl.P.T @ r)
        x = x + lvl.P @ xc
        x = _cheb_smooth(lvl, x, b, lvl.cheb_coefs)
        return x

    def precond(self, r):
        return self.cycle(0, np.asarray(r, dtype=np.float64))

    def aslinearoperator(self):
        import scipy.sparse.linalg as spla

        n = self.levels[0].A.shape[0]
        return spla.LinearOperator((n, n), matvec=self.precond)


def build_hierarchy(A, theta=0.0, max_levels=20, max_coarse=64, cheb_degree=2):
    """Builds the SA-AMG hierarchy for an SPD CSR matrix `A`."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    A = A.tocsr().astype(np.float64)
    levels = [_Level(A)]
    while levels[-1].A.shape[0] > max_coarse and len(levels) < max_levels:
        lvl = levels[-1]
        S = _strength_graph(lvl.A, theta)
        agg, nagg = _aggregate(S)
        if nagg >= lvl.A.shape[0]:  # no coarsening progress (diagonal matrix)
            break
        T = _tentative_prolongator(agg, nagg)
        rho = _rho_dinv_a(lvl.A, lvl.diag)
        lvl.rho = rho
        omega = (4.0 / 3.0) / rho
        Dinv_A = scipy.sparse.diags(1.0 / lvl.diag) @ lvl.A
        P = (T - omega * (Dinv_A @ T)).tocsr()
        lvl.P = P
        Ac = (P.T @ lvl.A @ P).tocsr()
        levels.append(_Level(Ac))

    # Smoother setup: Chebyshev on the upper spectrum [rho/alpha, 1.1 rho]
    # of D^{-1} A (alpha = 4: target the modes aggregation cannot represent).
    for lvl in levels[:-1]:
        rho = lvl.rho if lvl.rho is not None else _rho_dinv_a(lvl.A, lvl.diag)
        lvl.cheb_coefs = _chebyshev_coefs(rho / 4.0, 1.1 * rho, cheb_degree)

    coarse = levels[-1].A.tocsc()
    if coarse.shape[0] > 0:
        lu = spla.splu(coarse + 1e-300 * scipy.sparse.eye(coarse.shape[0], format="csc"))
        coarse_solve = lu.solve
    else:  # pragma: no cover - degenerate empty system
        coarse_solve = lambda b: b
    return AmgHierarchy(levels, coarse_solve, cheb_degree)
