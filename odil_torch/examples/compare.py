"""Teaching comparison on the Van der Pol oscillator, with no framework:

  1. forward Euler time stepping,
  2. ODIL with plain gradient descent on the discrete loss,
  3. ODIL with Newton on the whole space-time system (dense Jacobian),
  4. ODIL with Gauss-Newton from matrix-free jvp and vjp products.

One ODIL-Newton step on the global residual system is one global
Newton-Raphson step (the reference's examples/compare.md derives it), so
Newton and Gauss-Newton reproduce the Euler trajectory.  The port's
counterpart of ``examples/compare.py``: the same flags, methods and asserts,
in fp64 through torch autograd and ``torch.func`` on ``--device`` (default
``cuda``); the conjugate gradients are ``jax.scipy.sparse.linalg.cg``'s
iteration, and the dense Jacobian is solved on the host as there.

    python -m odil_torch.examples.compare --n 25 --tmax 2.5
    python -m odil_torch.examples.compare --device cpu
"""

import argparse

import numpy as np
import torch

MU = 1.0  # Van der Pol damping parameter.


def vdp_rhs(state):
    """The right-hand side at states (..., 2)."""
    x, y = state[..., 0], state[..., 1]
    return torch.stack([y, MU * (1 - x**2) * y - x], dim=-1)


def forward_euler(u0, n, dt):
    traj = [u0]
    u = u0
    for _ in range(n):
        u = u + dt * vdp_rhs(u)
        traj.append(u)
    return torch.stack(traj)


def residual(traj, u0, dt):
    """Euler residuals of the whole trajectory: r_i = u_{i+1} - u_i - dt f(u_i)."""
    traj = torch.cat([u0[None], traj], dim=0)
    return traj[1:] - traj[:-1] - dt * vdp_rhs(traj[:-1])


def odil_gd(u0, n, dt, epochs=20000, lr=0.05):
    traj = u0.repeat(n, 1)
    loss = None
    for _ in range(epochs):
        tr = traj.detach().requires_grad_(True)
        val = torch.sum(residual(tr, u0, dt) ** 2)
        (g,) = torch.autograd.grad(val, tr)
        traj = tr.detach() - lr * g
        loss = val.detach()
    return traj, float(loss)


def odil_newton_dense(u0, n, dt, iters=10):
    """Global Newton: J delta = -r with the dense trajectory Jacobian
    (``torch.func.jacfwd``), solved on the host."""
    traj = u0.repeat(n, 1)

    def r_of(flat):
        return residual(flat.reshape(n, 2), u0, dt).reshape(-1)

    loss = None
    for _ in range(iters):
        r = r_of(traj.reshape(-1))
        J = torch.func.jacfwd(r_of)(traj.reshape(-1))
        delta = np.linalg.solve(J.cpu().numpy(), -r.cpu().numpy())
        traj = traj + torch.as_tensor(delta, device=traj.device).reshape(n, 2)
        loss = float(torch.sum(r**2))
    return traj, float(loss)


def cg(A, b, tol=1e-5, maxiter=None):
    """``jax.scipy.sparse.linalg.cg`` from x0 = 0 with no preconditioner:
    its iteration and its stopping test gamma > tol^2 |b|^2."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = tol * tol * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    gamma = torch.sum(r * r)
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.sum(r * r)
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
    return x


def odil_gauss_newton_mf(u0, n, dt, iters=10):
    """Matrix-free Gauss-Newton: CG on J^T J delta = -J^T r through
    ``torch.func.jvp`` and ``torch.func.vjp``."""
    traj = u0.repeat(n, 1)

    def r_of(tr):
        return residual(tr, u0, dt).reshape(-1)

    loss = None
    for _ in range(iters):
        r, pullback = torch.func.vjp(r_of, traj)

        def matvec(v):
            return pullback(torch.func.jvp(r_of, (traj,), (v,))[1])[0]

        rhs = -pullback(r)[0]
        traj = traj + cg(matvec, rhs, tol=1e-12, maxiter=500)
        loss = torch.sum(r**2)
    return traj, float(loss)


def main(argv=None):
    parser = argparse.ArgumentParser()
    # The reference's scale (its examples/compare.py: n=25, dt=0.1): undamped
    # global Newton from the flat initial guess diverges on much longer Van
    # der Pol horizons, which is part of the lesson.
    parser.add_argument("--n", type=int, default=25, help="Number of Euler steps")
    parser.add_argument("--tmax", type=float, default=2.5)
    parser.add_argument("--device", type=str, default="cuda", help="Device of the tensors")
    args = parser.parse_args(argv)

    n, dt = args.n, args.tmax / args.n
    u0 = torch.tensor([2.0, 0.0], dtype=torch.float64, device=args.device)

    euler = forward_euler(u0, n, dt)[1:].cpu().numpy()
    traj_gd, loss_gd = odil_gd(u0, n, dt)
    traj_nt, loss_nt = odil_newton_dense(u0, n, dt)
    traj_gn, loss_gn = odil_gauss_newton_mf(u0, n, dt)

    def err(traj):
        return float(np.sqrt(np.mean((traj.cpu().numpy() - euler) ** 2)))

    print(f"ODIL-GD           loss={loss_gd:.3e}  vs-Euler RMS={err(traj_gd):.3e}")
    print(f"ODIL-Newton dense loss={loss_nt:.3e}  vs-Euler RMS={err(traj_nt):.3e}")
    print(f"ODIL-GN matfree   loss={loss_gn:.3e}  vs-Euler RMS={err(traj_gn):.3e}")
    assert err(traj_nt) < 1e-8, "Global Newton must reproduce the Euler trajectory"
    assert err(traj_gn) < 1e-6, "Matrix-free GN must reproduce the Euler trajectory"
    print("PASS")
    return dict(euler=euler, gd=traj_gd, newton=traj_nt, gn=traj_gn, loss_gd=loss_gd, loss_newton=loss_nt,
                loss_gn=loss_gn)


if __name__ == "__main__":
    main()
