"""The port stands alone: no module of odil_torch/, nor chip_smoke.py,
imports jax or anything of the JAX package (odil_tpu, odil).  Checked by
scanning the import statements of each source file."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "odil_tpu", "odil")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "odil_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {
        "chip_smoke.py",
        "odil_torch/__init__.py",
        "odil_torch/ops/rowwise_mg.py",
        "odil_torch/models/heat.py",
        "odil_torch/models/wave.py",
        "odil_torch/nn.py",
        "odil_torch/stencil.py",
        "odil_torch/parallel.py",
        "odil_torch/halo.py",
        "odil_torch/util.py",
        "odil_torch/optim/lbfgsb.py",
        "odil_torch/examples/veltracer.py",
        "odil_torch/examples/wave.py",
        "odil_torch/optim/lbfgs.py",
        "odil_torch/models/poisson.py",
        "odil_torch/models/advection.py",
        "odil_torch/examples/poisson.py",
        "odil_torch/examples/heat.py",
        "odil_torch/examples/heat_tmax.py",
        "odil_torch/examples/infer_constant.py",
        "odil_torch/examples/fields.py",
        "odil_torch/newton.py",
        "odil_torch/amg.py",
        "odil_torch/linsolver.py",
        "odil_torch/plot.py",
        "odil_torch/plotutil.py",
        "odil_torch/_cmapdata.py",
        "odil_torch/core_min.py",
        "odil_torch/examples/compare.py",
        "odil_torch/examples/heat_plot_train.py",
        "odil_torch/examples/poisson_plot_train.py",
        "odil_torch/examples/poisson_plot_field.py",
    } <= names


@pytest.mark.parametrize(
    "name",
    [
        "odil_torch.models.heat", "odil_torch.models.wave", "odil_torch.nn", "odil_torch.stencil", "odil_torch.problem",
        "odil_torch.ops.rowwise", "odil_torch.ops.rowwise_mg", "odil_torch.models.veltracer",
        "odil_torch.parallel", "odil_torch.halo",
        # The package itself (util, history, io, cache, checkpoint, linsolver, optim) and the CLIs.
        "odil_torch", "odil_torch.examples.veltracer", "odil_torch.examples.wave",
        # The optimizer, models and CLIs of the last slice.
        "odil_torch.optim.lbfgs", "odil_torch.models.poisson", "odil_torch.models.advection",
        "odil_torch.examples.poisson", "odil_torch.examples.heat", "odil_torch.examples.heat_tmax",
        "odil_torch.examples.infer_constant", "odil_torch.examples.fields",
        # Newton and the linear solvers.
        "odil_torch.newton", "odil_torch.amg", "odil_torch.linsolver",
        # Plots, post-processing and compare.py, in one interpreter.
        "odil_torch.plot, odil_torch.plotutil, odil_torch.core_min, odil_torch.examples.compare, "
        "odil_torch.examples.heat_plot_train, odil_torch.examples.poisson_plot_train, "
        "odil_torch.examples.poisson_plot_field",
    ],
)
def test_new_modules_import_without_jax(name):
    """Each module imports in a fresh interpreter that cannot import jax or
    the JAX package (a meta-path hook refuses them)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import %s\n" % (FORBIDDEN, name)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"
