"""Model artifact registry — the counterpart of
``rnnoise_tpu/weights/registry.py``, over the same ``models/`` directory.

Artifacts live in ``models/`` as ``<name>.blob`` with a ``models/MODELS``
manifest of ``<sha256>  <name>.blob`` lines.  ``load_registered`` refuses a
blob whose digest differs from the manifest's (the reference's sha256 pin of
its model tarball, download_model.sh:4-31).  ``MODELS_DIR`` and ``MANIFEST``
are module attributes, read at each call, so that a caller (a test) can
point them elsewhere.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict

from ..config import DEFAULT_MODEL, ModelConfig
from ..models.rnn import ModelParams
from .loader import load_model_bytes

MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models")
MANIFEST = os.path.join(MODELS_DIR, "MODELS")
DEFAULT_NAME = "rnnoise_synth_v1.blob"


def read_manifest() -> Dict[str, str]:
    """{artifact name: sha256 hex digest} from the manifest (empty when
    there is none)."""
    out = {}
    if os.path.exists(MANIFEST):
        with open(MANIFEST) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    digest, name = line.split(None, 1)
                    out[name.strip()] = digest
    return out


def register(name: str, blob: bytes) -> str:
    """Write ``blob`` to MODELS_DIR/name and pin its sha256 in the manifest;
    returns the digest."""
    os.makedirs(MODELS_DIR, exist_ok=True)
    with open(os.path.join(MODELS_DIR, name), "wb") as f:
        f.write(blob)
    digest = hashlib.sha256(blob).hexdigest()
    manifest = read_manifest()
    manifest[name] = digest
    with open(MANIFEST, "w") as f:
        f.write("# sha256  artifact\n")
        for n, d in sorted(manifest.items()):
            f.write(f"{d}  {n}\n")
    return digest


def load_registered(name: str = DEFAULT_NAME,
                    config: ModelConfig = DEFAULT_MODEL,
                    device="cuda") -> ModelParams:
    """The registered model ``name`` on ``device``.  Raises KeyError for a
    name the manifest lacks and ValueError for a blob whose sha256 differs
    from its pin."""
    manifest = read_manifest()
    if name not in manifest:
        raise KeyError(f"model {name!r} not in {MANIFEST}")
    with open(os.path.join(MODELS_DIR, name), "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != manifest[name]:
        raise ValueError(f"sha256 mismatch for {name}: {digest} != "
                         f"{manifest[name]}")
    return load_model_bytes(blob, config, device)
