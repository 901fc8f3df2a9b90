"""The port's C ABI on CPU: its shim (rnnoise_tpu_torch/native/rnnoise_capi.cc)
built with g++ against this interpreter, the repo's unchanged
native/capi_demo.c linked against it, and 20 frames of PCM through the C
client with RNNOISE_TPU_DEVICE=cpu, held to the port's StreamDenoiser up to
the client's int16 rounding (the contract of tests/test_capi.py)."""

import os
import subprocess

import numpy as np
import pytest

from rnnoise_tpu_torch import capi
from rnnoise_tpu_torch.api import RNNoise, StreamDenoiser
from tests.torch_helpers import CPU, MODEL_BLOB

F = 480


@pytest.fixture(scope="module")
def capi_demo(tmp_path_factory):
    built = capi.build_capi(str(tmp_path_factory.mktemp("capi")))
    return capi.build_demo(built)


@pytest.mark.parametrize("with_blob", [True, False])
def test_capi_matches_stream_denoiser(capi_demo, tmp_path, with_blob):
    """With a model file, and with a NULL model (the registered default)."""
    rng = np.random.default_rng(3)
    n_frames = 20
    pcm = (2500 * rng.standard_normal(F * n_frames)).astype(np.int16)
    in_path = tmp_path / "in.pcm"
    pcm.tofile(in_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RNNOISE_TPU_DEVICE"] = "cpu"
    with open(in_path, "rb") as stdin:
        res = subprocess.run([capi_demo] + ([MODEL_BLOB] if with_blob else []),
                             stdin=stdin, capture_output=True, env=env,
                             timeout=120)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out_c = np.frombuffer(res.stdout, np.int16)
    vads_c = [float(line.split()[1]) for line in res.stderr.decode().splitlines()
              if line.startswith("vad ")]
    assert len(out_c) == F * n_frames and len(vads_c) == n_frames

    den = StreamDenoiser(1, RNNoise.from_filename(MODEL_BLOB, device=CPU))
    outs, vads = [], []
    for f in range(n_frames):
        o, v = den.process_frame(pcm[f * F:(f + 1) * F].astype(np.float32)[None])
        outs.append(o[0])
        vads.append(float(v[0]))
    out_py = np.clip(np.round(np.concatenate(outs)), -32768, 32767)
    np.testing.assert_allclose(vads_c, vads, atol=1e-5)
    # the C client rounds half away from zero, np.round half to even
    assert np.abs(out_c - out_py).max() <= 1
