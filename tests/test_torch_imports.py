"""The port stands alone: no import of jax, optax or rnnoise_tpu anywhere
in rnnoise_tpu_torch/ (its bench included), chip_smoke.py or the Python
that scripts/torch_ci.sh runs (the GPU's machine has none of them)."""

import ast
import os
import re

from tests.torch_helpers import REPO


def _py_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "rnnoise_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _bad_imports(tree, where):
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            if n.split(".")[0] in ("jax", "jaxlib", "optax", "rnnoise_tpu"):
                bad.append(f"{where}:{node.lineno} {n}")
    return bad


def test_port_imports_neither_jax_nor_reference():
    bad = []
    files = list(_py_files())
    assert len(files) > 15
    assert os.path.join(REPO, "rnnoise_tpu_torch", "bench.py") in files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += _bad_imports(tree, os.path.relpath(path, REPO))
    assert not bad, bad


def test_ci_script_python_imports_neither_jax_nor_reference():
    """The Python that scripts/torch_ci.sh runs (its here-documents); the
    tests it runs import both packages, as every port test does."""
    with open(os.path.join(REPO, "scripts", "torch_ci.sh")) as f:
        docs = re.findall(r"<<'(\w+)'\n(.*?)\n\1\n", f.read(), re.S)
    assert docs
    bad = []
    for tag, body in docs:
        bad += _bad_imports(ast.parse(body), f"torch_ci.sh <<{tag}")
    assert not bad, bad


def test_package_imports_without_a_card():
    """Importing every module builds nothing and needs no CUDA."""
    import importlib
    for path in _py_files():
        rel = os.path.relpath(path, REPO)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".").removesuffix(".__init__")
        importlib.import_module(mod)
    from rnnoise_tpu_torch import kernels
    assert not {"rnn_step", "spectral", "analysis", "frame"} & set(kernels._LIBS)
    assert "frame" in kernels.KERNEL_SOURCES


def test_import_tf_leaves_h5py_unimported():
    """h5py is imported only when a Keras file is opened: the card's
    machine need not have it."""
    import subprocess
    import sys
    code = ("import sys; import rnnoise_tpu_torch.tools.import_tf; "
            "sys.exit('h5py' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr or "h5py was imported"
