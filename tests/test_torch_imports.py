"""The port stands alone: no import of jax or rnnoise_tpu anywhere in
rnnoise_tpu_torch/ or chip_smoke.py."""

import ast
import os

from tests.torch_helpers import REPO


def _py_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "rnnoise_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_neither_jax_nor_reference():
    bad = []
    files = list(_py_files())
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "rnnoise_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
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
    assert not {"rnn_step", "spectral"} & set(kernels._LIBS)
