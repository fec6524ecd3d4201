"""On-device L-BFGS with a strong-Wolfe zoom line search.

PyTorch counterpart of ``odil_tpu/optim/lbfgs.py:28-90``, which runs
``optax.lbfgs(memory_size=m, linesearch=optax.scale_by_zoom_linesearch(
max_linesearch_steps=maxls, initial_guess_strategy="one"))``.  The same
algorithm, step by step (optax 0.2.6: ``transform.py:1573-1750`` and
``linesearch.py:455-1330``):

- the memory: m pairs of parameter and gradient differences (s, y) and
  their weights rho = 1 / (y.s) (0 where y.s is 0) in a ring, updated
  before the direction is formed; the identity scale is
  (y.s) / (y.y) (1 where y.y is 0), and min(1, 1/|g|) at the first step;
- the direction: the two-loop recursion over the ring, newest pair first
  (entries never written are zero and leave the vector as it is, so the
  loops skip them);
- the zoom line search along u = -direction from the step 1: the interval
  search doubling the step, then cubic, quadratic or bisection steps inside
  the interval, the Armijo test relaxed by the approximate-Wolfe test
  (``approx_dec_rtol``), the curvature test, and the fallback to the
  largest step with sufficient decrease when the search runs out of steps.

The iterate, the gradient and the memory (two (m, P) buffers and rho) are
flat tensors on the domain's device; the recursion runs there without a
host sync.  The line search's branch decisions are taken on the host from
the value and the slope at each trial step: one host sync a line-search
step (the first step's sync also carries the value and slope at the
iterate).  Each iteration evaluates the loss and gradient at the iterate
once, plus the line search's own evaluations, with the epoch tracer fixed
within the iteration.  Iterations run in the chunks of ``Optimizer._chunks``;
the last step's terms and norms reach the callback through ``_emit``.  If
max|grad| at a chunk's last iterate is below ``pgtol``, ``EarlyStopError``
is raised with the JAX package's optinfo fields.

Over several processes (a state held in blocks, ``Optimizer.bind``'s
``whole`` and ``blocks`` maps) the iterate, the gradient and the memory are
whole on every process, as the JAX package's optax state is a global array:
each evaluation takes this process's blocks of the iterate and the
gradient's blocks are gathered whole after it (``whole``, which takes an
entry that several processes hold once, from one of them).  The values are
the route's loss, the same bits on every process, so the recursion and the
line search run unchanged and every process takes the same branches with
no collective of their own; the memory costs 2 m whole state vectors a
process (``memory_bytes``).
"""

from argparse import Namespace

import numpy as np
import torch

from .base import EarlyStopError, Optimizer

__all__ = ["LbfgsOptimizer", "zoom_linesearch"]

# optax.scale_by_zoom_linesearch's defaults.
TOL, INCREASE_FACTOR, SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL, INTERVAL_THRESHOLD = 0.0, 2.0, 1e-4, 0.9, 1e-6, 1e-5


def _f(x):
    return np.float64(x)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (``linesearch.py:455``)."""
    C = fpa
    db = b - a
    dc = c - a
    p = db * dc
    denom = (p * p) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch.py:496``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """The sufficient-decrease error, relaxed by the approximate-Wolfe test;
    inf where NaN."""
    error = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    error = np.maximum(np.minimum(np.maximum(approx, delta), error), 0.0)
    return np.inf if np.isnan(error) else error


def _curvature_error(slope, slope_init):
    error = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), 0.0)
    return np.inf if np.isnan(error) else error


def zoom_linesearch(value_slope, value_init, slope_init, maxls, first=None):
    """The stepsize of optax's zoom line search from the guess 1.

    value_slope(t) -> (value, slope) at the step t (host floats);
    first: (value, slope) at t = 1 if already known.  Returns (stepsize,
    number of steps), the steps' evaluations being the calls of
    value_slope (plus `first`)."""
    with np.errstate(all="ignore"):
        vi, si = _f(value_init), _f(slope_init)
        count = 0
        stepsize, value, slope = _f(0.0), vi, si
        decrease_error = np.inf
        interval_found = done = failed = False
        low, value_low, slope_low = _f(0.0), vi, si
        high, value_high, slope_high = _f(0.0), vi, si
        cubic_ref, value_cubic_ref = _f(0.0), vi
        safe_stepsize, safe_value = _f(0.0), vi
        while not (done or failed):
            if not interval_found:
                # The interval search (Nocedal and Wright, Algorithm 3.5).
                new = _f(1.0) if count == 0 else INCREASE_FACTOR * stepsize
                if count == 0 and first is not None:
                    nv, ns = first
                else:
                    nv, ns = value_slope(float(new))
                nv, ns = _f(nv), _f(ns)
                dec = _decrease_error(new, nv, ns, vi, si)
                error = np.maximum(dec, _curvature_error(ns, si))
                if dec <= TOL:
                    safe_stepsize, safe_value = new, nv
                high_to_new = bool(dec > 0.0) or (bool(nv >= value) and count > 0)
                low_to_new = bool(ns >= 0.0) and not high_to_new
                if low_to_new:
                    low, value_low, slope_low, high, value_high, slope_high = new, nv, ns, stepsize, value, slope
                else:
                    low, value_low, slope_low, high, value_high, slope_high = stepsize, value, slope, new, nv, ns
                interval_found = high_to_new or low_to_new or bool(error <= TOL)
                done = bool(error <= TOL)
                failed = count + 1 >= maxls and not done
                cubic_ref, value_cubic_ref = low, value_low
            else:
                # The zoom (Algorithm 3.6).
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = bool(delta <= INTERVAL_THRESHOLD)
                cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref, value_cubic_ref)
                use_cubic = bool(cubic > left + 0.2 * delta) and bool(cubic < right - 0.2 * delta)
                quad = _quadmin(low, value_low, slope_low, high, value_high)
                use_quad = not use_cubic and bool(quad > left + 0.1 * delta) and bool(quad < right - 0.1 * delta)
                new = cubic if use_cubic else quad if use_quad else (low + high) / 2.0
                nv, ns = value_slope(float(new))
                nv, ns = _f(nv), _f(ns)
                dec = _decrease_error(new, nv, ns, vi, si)
                error = np.maximum(dec, _curvature_error(ns, si))
                if dec <= TOL and nv < safe_value:
                    safe_stepsize, safe_value = new, nv
                done = bool(error <= TOL)
                high_to_middle = bool(dec > 0.0) or bool(nv >= value_low)
                high_to_low = bool(ns * (high - low) >= 0.0) and not high_to_middle
                if high_to_middle or high_to_low:
                    cubic_ref, value_cubic_ref = high, value_high
                else:
                    cubic_ref, value_cubic_ref = low, value_low
                if high_to_middle:
                    high, value_high, slope_high = new, nv, ns
                if high_to_low:
                    high, value_high, slope_high = low, value_low, slope_low
                if not high_to_middle:
                    low, value_low, slope_low = new, nv, ns
                failed = (count + 1 >= maxls or (too_small and bool(safe_stepsize > 0.0))) and not done
            count += 1
            stepsize, value, slope, decrease_error = new, nv, ns, dec
            if failed and (safe_stepsize > 0.0 or np.isinf(decrease_error)):
                stepsize = safe_stepsize
        return float(stepsize), count


class _Memory:
    """The L-BFGS memory on the device: the ring of (s, y) pairs as two
    (m, P) buffers, their weights rho, and the last iterate and gradient."""

    def __init__(self, m, like):
        self.m = m
        self.s = torch.zeros((m,) + tuple(like.shape), dtype=like.dtype, device=like.device)
        self.y = torch.zeros_like(self.s)
        self.rho = torch.zeros((m,), dtype=like.dtype, device=like.device)
        self.count = 0
        self.x = self.g = None

    def direction(self, x, g):
        """Stores the newest pair (from the last iterate and gradient) and
        returns the preconditioned gradient P g (``scale_by_lbfgs``)."""
        m, k = self.m, self.count
        if k > 0:
            ds, dy = x - self.x, g - self.g
            dot = torch.dot(dy, ds)
            j = (k - 1) % m
            self.s[j] = ds
            self.y[j] = dy
            self.rho[j] = torch.where(dot == 0.0, 0.0, 1.0 / dot)
            den = torch.dot(dy, dy)
            scale = torch.where(den > 0.0, dot / den, 1.0)
        else:
            scale = torch.minimum(torch.ones((), dtype=g.dtype, device=g.device), 1.0 / torch.linalg.vector_norm(g))
        vec, alphas = g, []
        for i in range(min(k, m)):  # newest pair first
            j = (k - 1 - i) % m
            alpha = self.rho[j] * torch.dot(self.s[j], vec)
            vec = vec - alpha * self.y[j]
            alphas.append((j, alpha))
        vec = scale * vec
        for j, alpha in reversed(alphas):
            beta = self.rho[j] * torch.dot(self.y[j], vec)
            vec = vec + (alpha - beta) * self.s[j]
        self.x, self.g = x, g
        self.count = k + 1
        return vec


class LbfgsOptimizer(Optimizer):

    def __init__(self, pgtol=1e-16, m=50, maxls=50, factr=0, dtype=None, mod=None, **kwargs):
        super().__init__(name="lbfgs", displayname="L-BFGS", dtype=dtype, mod=mod)
        self.pgtol = pgtol if pgtol is not None else 1e-16
        self.m = m
        self.maxls = maxls
        self.memory = None  # _Memory of the last run
        self.x = None  # the flat iterate of the last run
        self.grad_evals = 0  # loss+grad evaluations, the line search's included
        self.host_syncs = 0  # waits of the host for the device

    def run(self, x0, loss_grad=None, epochs=None, callback=None, epoch_start=0, **kwargs):
        if self.loss_fn is None:
            raise RuntimeError(
                "LbfgsOptimizer requires a bound device loss function; use util.optimize_grad or call "
                ".bind(loss_fn, ...)"
            )
        block_grad_fn = self._grad_fn()
        whole, blocks = self.whole, self.blocks

        def grad_fn(arrays, tracers):
            out, grads = block_grad_fn(blocks(arrays), tracers)
            return out, whole(grads)

        x0 = whole([a.detach() for a in x0])
        shapes = [tuple(a.shape) for a in x0]
        sizes = [int(np.prod(s)) for s in shapes]

        def unflat(v):
            return [p.view(s) for p, s in zip(torch.split(v, sizes), shapes)]

        def flat(arrays):
            return torch.cat([a.reshape(-1) for a in arrays])

        x = flat(x0)
        self.x = x
        self.memory = memory = _Memory(self.m, x)
        tracers = dict(self.tracers)
        epoch = epoch_start
        for n in self._chunks(epoch_start, epochs):
            losses = torch.empty((n,), dtype=x.dtype, device=x.device)
            for i in range(n):
                tracers["epoch"] = epoch + i
                (loss, (terms, norms)), grads = grad_fn(unflat(x), tracers)
                self.grad_evals += 1
                losses[i] = loss
                g = flat(grads)
                u = -memory.direction(x, g)

                def trial(t, x=x, u=u):
                    (v, _), gt = grad_fn(unflat(x + t * u), tracers)
                    self.grad_evals += 1
                    return torch.stack([v.to(u.dtype), torch.dot(flat(gt), u)])

                def value_slope(t):
                    self.host_syncs += 1
                    return trial(t).tolist()

                # The first trial step (t = 1) does not depend on the value and
                # slope at x: its evaluation and theirs share one host sync.
                head = torch.cat([torch.stack([loss.to(u.dtype), torch.dot(u, g)]), trial(1.0)]).tolist()
                self.host_syncs += 1
                value_init, slope_init, first = head[0], head[1], head[2:]
                stepsize, _ = zoom_linesearch(value_slope, value_init, slope_init, self.maxls, first=first)
                x = x + stepsize * u
                gmax = g.abs().max()
            self.x = x
            self.evals += n
            stacked = (losses, torch.stack(list(terms))[None], torch.stack(list(norms))[None])
            self._emit(callback, blocks(unflat(x)), epoch, stacked, n)
            epoch += n
            gmax = float(gmax)
            self.host_syncs += 1
            if gmax < self.pgtol:
                optinfo = Namespace(
                    warnflag=0,
                    task=f"CONVERGED: max|grad|={gmax:.3e} < pgtol={self.pgtol:.3e}",
                    evals=self.evals,
                    epochs=epoch - epoch_start,
                    x=blocks(unflat(x)),
                )
                raise EarlyStopError(optinfo.task, optinfo)
        return blocks(unflat(x)), Namespace(epochs=epochs, evals=self.evals)

    @property
    def memory_bytes(self):
        """The bytes of the last run's (s, y) ring on its device (2 m whole
        state vectors, on every process)."""
        s = self.memory.s
        return 2 * s.numel() * s.element_size()
