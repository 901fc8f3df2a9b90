"""The port's model registry (the sha256-pinned models/MODELS manifest) and
its demo command line, on CPU.  Tests that register point the registry at
a manifest under tmp_path: the tracked one is the JAX package's file."""

import hashlib
import os

import numpy as np
import pytest
import torch

from rnnoise_tpu.weights import registry as jregistry
from rnnoise_tpu_torch.api import RNNoise, StreamDenoiser
from rnnoise_tpu_torch.tools import demo
from rnnoise_tpu_torch.weights import registry
from rnnoise_tpu_torch.weights.loader import load_model_file
from tests.torch_helpers import CPU, MODEL_BLOB, make_signal

F = 480


def _same_params(a, b):
    for la, lb in zip(a, b):
        for ta, tb in zip(la, lb):
            assert (ta is None) == (tb is None)
            if ta is not None:
                assert ta.dtype == tb.dtype and torch.equal(ta, tb)


@pytest.fixture()
def tmp_registry(tmp_path, monkeypatch):
    monkeypatch.setattr(registry, "MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(registry, "MANIFEST", str(tmp_path / "MODELS"))
    return tmp_path


def test_tracked_manifest_pins_the_default_model():
    """The repo's manifest reads as the JAX package reads it, and the pinned
    default model loads equal to the file loaded directly."""
    assert registry.read_manifest() == jregistry.read_manifest()
    assert registry.DEFAULT_NAME in registry.read_manifest()
    _same_params(registry.load_registered(device="cpu"),
                 load_model_file(MODEL_BLOB, device="cpu"))


def test_register_round_trips(tmp_registry):
    blob = open(MODEL_BLOB, "rb").read()
    digest = registry.register("a.blob", blob)
    assert digest == hashlib.sha256(blob).hexdigest()
    registry.register("b.blob", blob[:100])
    assert registry.read_manifest() == {
        "a.blob": digest, "b.blob": hashlib.sha256(blob[:100]).hexdigest()}
    assert (tmp_registry / "a.blob").read_bytes() == blob
    _same_params(registry.load_registered("a.blob", device="cpu"),
                 load_model_file(MODEL_BLOB, device="cpu"))


def test_mismatched_and_unknown_models_are_refused(tmp_registry):
    blob = open(MODEL_BLOB, "rb").read()
    registry.register("a.blob", blob)
    (tmp_registry / "a.blob").write_bytes(
        blob[:1000] + bytes([blob[1000] ^ 1]) + blob[1001:])
    with pytest.raises(ValueError, match="sha256 mismatch"):
        registry.load_registered("a.blob", device="cpu")
    with pytest.raises(KeyError):
        registry.load_registered("missing.blob", device="cpu")


def test_demo_cli_equals_the_api(tmp_path):
    """The demo with --device cpu (default model, 2 streams) writes the
    port's StreamDenoiser output, rounded and less its first frame."""
    rng = np.random.default_rng(11)
    n_frames = 20
    pcm = np.clip(np.round(make_signal(rng, n_frames)), -32768,
                  32767).astype("<i2")
    src, dst = tmp_path / "in.pcm", tmp_path / "out.pcm"
    pcm.tofile(src)
    demo.main(["--device", "cpu", "--streams", "2", "--chunk-frames", "8",
               str(src), str(dst)])
    got = np.fromfile(dst, dtype="<i2")
    assert len(got) == len(pcm) - F

    den = StreamDenoiser(1, RNNoise.from_filename(MODEL_BLOB, device=CPU))
    want = np.concatenate([den.process_chunk(
        pcm[i * F:(i + 8) * F].astype(np.float32).reshape(1, -1, F))[0].ravel()
        for i in range(0, n_frames, 8)])
    want = np.clip(np.round(want[F:]), -32768, 32767).astype("<i2")
    np.testing.assert_array_equal(got, want)
