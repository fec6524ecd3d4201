"""The port's op namespaces (``odil_torch/backend.py``) against the JAX
package's (``odil_tpu/backend.py``): every public name of ``ModBase`` and
``ModJax`` on ``ModTorch``, one case a name, and ``ModNumpy`` against the
JAX package's ``ModNumpy``.  Inputs are numpy draws from a seed; fp64
results agree within 1e-12, integer results exactly, and each result has
the JAX result's shape and dtype (64-bit values on, as a float64 Domain
turns them on in either package).  The traps of NumPy against torch
(``transpose`` without axes, ``std``'s ddof, ``median`` of an even count,
``min``/``max``/``argmax``/``argmin`` with an axis, the constructors'
dtypes, ``linspace``'s endpoint) have cases of their own; the convolutions
are held against ``jax.lax`` over 1-3 dimensions, strides 1 and 2 and
both paddings."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from odil_tpu.backend import ModJax  # noqa: E402
from odil_tpu.backend import ModNumpy as JaxModNumpy  # noqa: E402
from odil_torch.backend import FORWARDED, ModNumpy, ModTorch  # noqa: E402

SEED = 11


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.values["jax_enable_x64"]
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _draw(*shape):
    return np.random.default_rng(SEED + len(shape)).normal(size=shape)


X = _draw(4, 6)
EVEN = _draw(4, 6)  # an even count along both axes and whole
ODD = _draw(5, 3)
IDX = np.array([[0, 1], [3, 5], [2, 2]])


def _cases():
    """name -> fn(mod, A) with A turning a numpy array into the mod's array."""
    return {
        "abs": lambda m, A: m.abs(A(X)),
        "arange": lambda m, A: [m.arange(5), m.arange(1, 7, 2), m.arange(0.0, 1.0, 0.25),
                                m.arange(3, dtype=np.float32)],
        "arctan2": lambda m, A: [m.arctan2(A(X), A(X[::-1].copy())), m.arctan2(A(X), 0.5)],
        "argmax": lambda m, A: [m.argmax(A(X)), m.argmax(A(X), axis=0), m.argmax(A(X), axis=1)],
        "argmin": lambda m, A: [m.argmin(A(X)), m.argmin(A(X), axis=0), m.argmin(A(X), axis=1)],
        "broadcast_to": lambda m, A: m.broadcast_to(A(X[0]), (3, 6)),
        "clip": lambda m, A: [m.clip(A(X), -0.5, 0.5), m.clip(A(X), None, 0.1), m.clip(A(X), -0.2, None)],
        "concatenate": lambda m, A: [m.concatenate([A(X), A(X)], axis=1), m.concatenate([A(X), A(X[:2].copy())]),
                                     m.concatenate([A(X), A(ODD)], axis=None)],
        "cos": lambda m, A: m.cos(A(X)),
        "cosh": lambda m, A: m.cosh(A(X)),
        "cumsum": lambda m, A: [m.cumsum(A(X)), m.cumsum(A(X), axis=0), m.cumsum(A(X), axis=1)],
        "einsum": lambda m, A: [m.einsum("ij,kj->ik", A(X), A(X)), m.einsum("ii->i", A(X[:, :4].copy())),
                                m.einsum("ij->", A(X))],
        "exp": lambda m, A: m.exp(A(X)),
        "floor": lambda m, A: m.floor(A(3 * X)),
        "full": lambda m, A: [m.full((2, 3), 2.5), m.full((2, 3), 2), m.full(4, 1.5, dtype=np.float32)],
        "hstack": lambda m, A: [m.hstack([A(X), A(X)]), m.hstack([A(X[0]), A(ODD[0])])],
        "linspace": lambda m, A: [m.linspace(0, 1, 7), m.linspace(-2.0, 3.0, 11, endpoint=False), m.linspace(1, 2, 1),
                                  m.linspace(0, 1, 5, dtype=np.float32)],
        "log": lambda m, A: m.log(A(np.abs(X) + 0.1)),
        "matmul": lambda m, A: [m.matmul(A(X), A(X.T.copy())), m.matmul(A(X), A(X[0]))],
        "maximum": lambda m, A: [m.maximum(A(X), A(X[::-1].copy())), m.maximum(A(X), 0.2)],
        "mean": lambda m, A: [m.mean(A(X)), m.mean(A(X), axis=0), m.mean(A(X), axis=(0, 1))],
        "median": lambda m, A: [m.median(A(EVEN)), m.median(A(EVEN), axis=0), m.median(A(EVEN), axis=1),
                                m.median(A(ODD)), m.median(A(ODD), axis=0)],
        "meshgrid": lambda m, A: list(m.meshgrid(A(X[0]), A(ODD[:, 0].copy()))) + list(
            m.meshgrid(A(X[0]), A(ODD[:, 0].copy()), indexing="ij")),
        "minimum": lambda m, A: [m.minimum(A(X), A(X[::-1].copy())), m.minimum(A(X), 0.2)],
        "moveaxis": lambda m, A: m.moveaxis(A(_draw(2, 3, 4)), 0, -1),
        "ones": lambda m, A: [m.ones((2, 3)), m.ones(4, dtype=np.float32)],
        "ones_like": lambda m, A: m.ones_like(A(X)),
        "pad": lambda m, A: [m.pad(A(X), ((1, 2), (0, 1))), m.pad(A(X), 2), m.pad(A(X), (1, 2)),
                             m.pad(A(X), ((1, 2), (2, 1)), constant_values=3.0)]
        + [m.pad(A(X), ((1, 2), (2, 1)), mode=mode) for mode in ("wrap", "edge", "reflect", "symmetric")],
        "reshape": lambda m, A: [m.reshape(A(X), (3, 8)), m.reshape(A(X), (-1,)), m.reshape(A(X), (2, -1, 3))],
        "roll": lambda m, A: [m.roll(A(X), 1, 0), m.roll(A(X), (1, -2), (0, 1)), m.roll(A(X), 3)],
        "sin": lambda m, A: m.sin(A(X)),
        "sinh": lambda m, A: m.sinh(A(X)),
        "sqrt": lambda m, A: m.sqrt(A(np.abs(X))),
        "square": lambda m, A: m.square(A(X)),
        "stack": lambda m, A: [m.stack([A(X), A(X)]), m.stack([A(X), A(X)], axis=-1)],
        "std": lambda m, A: [m.std(A(X)), m.std(A(X), axis=0), m.std(A(X), axis=1, ddof=1)],
        "sum": lambda m, A: [m.sum(A(X)), m.sum(A(X), axis=1), m.sum(A(X), axis=(0, 1))],
        "tanh": lambda m, A: m.tanh(A(X)),
        "transpose": lambda m, A: [m.transpose(A(_draw(2, 3, 4))), m.transpose(A(_draw(2, 3, 4)), (1, 0, 2))],
        "where": lambda m, A: [m.where(A(X) > 0, A(X), A(-X)), m.where(A(X) > 0, A(X), 0.0)],
        "zeros": lambda m, A: [m.zeros((2, 3)), m.zeros(4, dtype=np.float32)],
        "zeros_like": lambda m, A: m.zeros_like(A(X)),
        "min": lambda m, A: [m.min(A(X)), m.min(A(X), axis=0), m.min(A(X), axis=1)],
        "max": lambda m, A: [m.max(A(X)), m.max(A(X), axis=0), m.max(A(X), axis=1)],
        "flatten": lambda m, A: m.flatten(A(X)),
        "relu": lambda m, A: m.relu(A(X)),
        "sigmoid": lambda m, A: m.sigmoid(A(X)),
        "norm": lambda m, A: m.norm(A(X)),
        "cast": lambda m, A: [m.cast(A(X), np.float32), m.cast(A(3 * X), np.int32), m.cast(X, np.float64)],
        "gather_nd": lambda m, A: m.gather_nd(A(X), A(IDX)),
        "split_by_sizes": lambda m, A: m.split_by_sizes(A(X), [1, 3], axis=0) + m.split_by_sizes(A(X), [2, 4], 1),
        "array": lambda m, A: [m.array(X), m.array(X, dtype=np.float32), m.array(1.5), m.array([1, 2])],
        "constant": lambda m, A: m.constant(X),
        "variable": lambda m, A: [m.variable(X), m.variable(X, dtype=np.float32)],
        "copy": lambda m, A: m.copy(A(X)),
        "native": lambda m, A: m.native(X),
    }


CASES = _cases()


def _host(r):
    if torch.is_tensor(r):
        return r.detach().cpu().numpy()
    return np.asarray(r)


def _hold(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _host(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_every_name_is_there():
    """ModTorch has every public name of ModJax (and so of ModBase), and the
    port's ModNumpy every public name of the JAX package's."""
    assert _public(ModJax()) <= _public(ModTorch("cpu"))
    assert _public(JaxModNumpy()) <= _public(ModNumpy())
    assert set(FORWARDED) <= set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mod_torch_against_mod_jax(name):
    """One name of ModTorch against ModJax on the same numpy inputs."""
    fn = CASES[name]
    want = fn(ModJax(), jnp.asarray)
    got = fn(ModTorch("cpu", x64=True), torch.from_numpy)
    _hold(got, want)


@pytest.mark.parametrize("name", sorted(set(FORWARDED) | {"min", "max", "flatten", "relu", "sigmoid", "norm", "cast",
                                                          "gather_nd", "split_by_sizes", "array", "copy"}))
def test_mod_numpy_against_jax_package(name):
    """The port's ModNumpy against the JAX package's on one name."""
    fn = CASES[name]
    _hold(fn(ModNumpy(), np.asarray), fn(JaxModNumpy(), np.asarray))


def test_defaults_without_x64():
    """Without 64-bit values the constructors give float32 and int32, as
    jax.numpy does with jax_enable_x64 off; a float64 Domain turns them on."""
    import odil_torch

    m = ModTorch("cpu", x64=False)
    assert m.ones(2).dtype == m.zeros(2).dtype == m.full(2, 1.0).dtype == m.linspace(0, 1, 3).dtype == torch.float32
    assert m.arange(3).dtype == m.full(2, 1).dtype == torch.int32 and m.array(1.5).dtype == torch.float32
    d = odil_torch.Domain((4, 4), dtype=np.float64, device="cpu")
    assert d.mod.ones(2).dtype == torch.float64 and d.mod.arange(2).dtype == torch.int64


def test_host_and_identity_names():
    """The names that hold no computation: the namespaces, the scipy
    sparse hooks (the same scipy objects), numpy, stop_gradient,
    is_tensor, ndarray, spnative and jit_wrap (the identity: eager)."""
    mj, mt = ModJax(), ModTorch("cpu")
    for name in ("modsp", "csr_matrix", "diags", "bmat", "block_diag", "tril", "spnorm", "spsolve"):
        assert getattr(mt, name) is getattr(mj, name), name
    assert mt.xp is torch and mt.mod is torch and mt.jax is None and mt.tf is None
    t = torch.from_numpy(X).requires_grad_(True)
    assert np.array_equal(mt.numpy(t), X) and not mt.stop_gradient(t).requires_grad
    assert mt.is_tensor(t) and not mt.is_tensor(X) and isinstance(t, mt.ndarray)
    assert mt.spnative(X) is X

    def f(v):
        return v * 2

    assert mt.jit_wrap()(f) is f and mt.jit_wrap(static_argnums=0)(f) is f


def test_random():
    """random.set_seed, uniform, normal and next_key: the shape and dtype
    of the JAX package's draws, the same draws after the same seed, and
    their moments (1e5 draws, within 5 standard errors)."""
    mj, mt = ModJax(), ModTorch("cpu")
    mj.random.set_seed(3)
    for fn, args in ((lambda m: m.random.uniform((3, 4)), ()), (lambda m: m.random.normal((5,), dtype=np.float64), ()),
                     (lambda m: m.random.uniform((2,), minval=-1.0, maxval=2.0), ())):
        w, g = np.asarray(fn(mj)), _host(fn(mt))
        assert g.shape == w.shape and g.dtype == w.dtype
    mt.random.set_seed(5)
    a = mt.random.normal((100000,), mean=1.5, stddev=2.0, dtype=np.float64)
    mt.random.set_seed(5)
    b = mt.random.normal((100000,), mean=1.5, stddev=2.0, dtype=np.float64)
    assert torch.equal(a, b)
    n = a.numel()
    assert abs(float(a.mean()) - 1.5) < 5 * 2.0 / n ** 0.5 and abs(float(a.std()) - 2.0) < 5 * 2.0 / (2 * n) ** 0.5
    u = mt.random.uniform((100000,), minval=-1.0, maxval=3.0, dtype=np.float64)
    assert float(u.min()) >= -1.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 1.0) < 5 * (16 / 12) ** 0.5 / n ** 0.5
    k1, k2 = mt.random.next_key(), mt.random.next_key()
    assert isinstance(k1, torch.Generator) and k1.initial_seed() != k2.initial_seed()


CONV_CASES = [(nd, s, pad) for nd in (1, 2, 3) for s in (1, 2) for pad in ("VALID", "SAME")]


@pytest.mark.parametrize("nd,stride,padding", CONV_CASES)
def test_convolution_against_lax(nd, stride, padding):
    """convolution: jax.lax's single-channel cross-correlation (through
    ModJax), XLA's SAME padding at stride 2 included; an explicit padding
    and tuple strides too."""
    rng = np.random.default_rng(SEED + nd)
    u, f = rng.normal(size=(9, 8, 7)[:nd]), rng.normal(size=(3, 2, 3)[:nd])
    mj, mt = ModJax(), ModTorch("cpu", x64=True)
    _hold(mt.convolution(torch.from_numpy(u), torch.from_numpy(f), stride, padding),
          mj.convolution(jnp.asarray(u), jnp.asarray(f), stride, padding))
    strides, pads = (stride,) + (1,) * (nd - 1), [(1, 2)] + [(0, 1)] * (nd - 1)
    _hold(mt.convolution(torch.from_numpy(u), torch.from_numpy(f), strides, pads),
          mj.convolution(jnp.asarray(u), jnp.asarray(f), strides, pads))


@pytest.mark.parametrize("nd,stride,padding", CONV_CASES + [(0, 1, "VALID")])
def test_conv_transpose_against_lax(nd, stride, padding):
    """conv_transpose: jax.lax.conv_transpose's defaults (channels-last
    layouts, the kernel not flipped), 0-3 spatial dimensions (NC/IO up to
    NHWDC/HWDIO)."""
    rng = np.random.default_rng(SEED + 10 + nd)
    lhs, rhs = rng.normal(size=(2,) + (9, 8, 7)[:nd] + (3,)), rng.normal(size=(3, 2, 3)[:nd] + (3, 4))
    mj, mt = ModJax(), ModTorch("cpu", x64=True)
    _hold(mt.conv_transpose(torch.from_numpy(lhs), torch.from_numpy(rhs), strides=stride, padding=padding),
          mj.conv_transpose(jnp.asarray(lhs), jnp.asarray(rhs), strides=stride, padding=padding))


def test_convolutions_run_in_full_fp32():
    """The convolutions pin fp32 (no TF32) though the mod was built without
    a Domain."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    mt = ModTorch("cpu")
    mt.convolution(torch.ones(5, 5), torch.ones(3, 3), 1, "VALID")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    mt.conv_transpose(torch.ones(1, 5, 2), torch.ones(3, 2, 2), strides=2, padding="SAME")
    assert not torch.backends.cudnn.allow_tf32
