"""The port's offline tools (rnnoise_tpu_torch/tools: shrink_model,
dump_tables, import_torch, import_tf, sweep, rir_deconv) and examples
against the JAX package's on CPU, from the same numpy-seeded inputs: the
blob and table tools and the RIR measurement bit for bit, the importers'
params exactly and their blobs byte for byte; then a measured RIR chained
into the port's feature extraction."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (keras_file, keras_layers, record_session, room_rir,
                        torch_state_dict, write_keras_h5)
from rnnoise_tpu.tools import dump_tables as jdump_tables
from rnnoise_tpu.tools import import_tf as jimport_tf
from rnnoise_tpu.tools import import_torch as jimport_torch
from rnnoise_tpu.tools import rir_deconv as jrir
from rnnoise_tpu.tools import shrink_model as jshrink
from rnnoise_tpu.tools import sweep as jsweep
from rnnoise_tpu.training.export import export_blob as jexport_blob
from rnnoise_tpu_torch.api import RNNoise, StreamDenoiser
from rnnoise_tpu_torch.config import ModelConfig
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
from rnnoise_tpu_torch.tools import dump_tables, import_tf, import_torch
from rnnoise_tpu_torch.tools import rir_deconv, shrink_model, sweep
from rnnoise_tpu_torch.training.export import export_blob
from rnnoise_tpu_torch.training.model import (init_params, params_from_numpy,
                                              params_to_numpy)
from tests.conftest import speechlike
from tests.torch_helpers import (CPU, MODEL_BLOB, REPO, make_signal,
                                 no_jax_compile_cache)  # noqa: F401

LITTLE_BLOB = os.path.join(REPO, "models", "rnnoise_synth_v1_little.blob")
SMALL = ModelConfig(cond_size=32, gru_size=64)
SPEC = sweep.SweepSpec(duration=4.0, gap=0.5, pilot_duration=0.25)
LAYERS = ("conv1", "conv2", "gru1", "gru2", "gru3", "dense_out", "vad_dense")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# -- shrink_model -------------------------------------------------------------

def test_shrink_equals_jax_and_little_blob(tmp_path, monkeypatch):
    blob, little = _read(MODEL_BLOB), _read(LITTLE_BLOB)
    small = shrink_model.shrink(blob)
    assert (len(blob), len(small)) == (5682880, 1553664)
    assert small == jshrink.shrink(blob) == little
    assert shrink_model.main([MODEL_BLOB, str(tmp_path / "port.blob")]) == 0
    monkeypatch.setattr(sys, "argv", ["shrink_model", MODEL_BLOB,
                                      str(tmp_path / "jax.blob")])
    jshrink.main()
    assert _read(tmp_path / "port.blob") == _read(tmp_path / "jax.blob")


def test_little_blob_serves_like_the_full_blob():
    """S=4, T=10 through process_frames_tm_i16 on the CPU: the int8 layers
    never read the float copies that shrink drops."""
    rng = np.random.default_rng(21)
    sig = np.stack([make_signal(rng, 10) for _ in range(4)])
    pcm = torch.from_numpy(np.clip(np.round(sig), -32768, 32767)
                           .astype(np.int16).reshape(4, 10, 480)
                           .transpose(1, 0, 2).copy())
    outs = []
    for path in (MODEL_BLOB, LITTLE_BLOB):
        model = RNNoise.from_filename(path, device="cpu")
        st, out, vad = process_frames_tm_i16(
            model.params, init_state(4, model.config, CPU), pcm)
        outs.append((out, vad, st.lastg))
    (out_a, vad_a, g_a), (out_b, vad_b, g_b) = outs
    assert out_a.dtype == torch.int16 and tuple(out_a.shape) == (10, 4, 480)
    assert torch.equal(out_a, out_b) and torch.equal(vad_a, vad_b)
    assert torch.equal(g_a, g_b)


# -- dump_tables --------------------------------------------------------------

def test_dump_tables_equals_jax(tmp_path, monkeypatch):
    assert dump_tables.main([str(tmp_path / "port.npz")]) == 0
    monkeypatch.setattr(sys, "argv", ["dump_tables", str(tmp_path / "jax.npz")])
    jdump_tables.main()
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 8
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["band_matrix"].shape == (32, 481)
    assert got["dct_matrix"].shape == (32, 32)


# -- import_torch -------------------------------------------------------------

def _seeded_params(seed=7):
    """The port's init_params at SMALL as numpy (each of z, r, n drawn on
    its own, so the r and z blocks differ)."""
    return params_to_numpy(init_params(torch.Generator().manual_seed(seed),
                                       SMALL, "cpu"))


def _assert_tree_equal(got, want):
    """``got`` (the port's tensors) equal ``want`` (numpy) leaf for leaf,
    layer for layer."""
    assert list(got) == list(LAYERS) and set(want) == set(LAYERS)
    for layer in LAYERS:
        assert list(got[layer]) == list(want[layer]), layer
        for name, t in got[layer].items():
            assert t.dtype == torch.float32 and t.requires_grad, (layer, name)
            assert t.is_leaf and t.is_contiguous(), (layer, name)
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(want[layer][name]),
                                          err_msg=f"{layer}.{name}")


@pytest.mark.parametrize("form", ["bare", "state_dict"])
def test_import_torch_equals_jax_and_seed(tmp_path, form):
    params = _seeded_params()
    N = SMALL.gru_size
    for g in ("gru1", "gru2", "gru3"):       # the r/z swap must matter
        for leaf in ("w_in", "b_in", "w_rec", "b_rec"):
            a = params[g][leaf]
            assert not np.array_equal(a[..., :N], a[..., N:2 * N])
    sd = torch_state_dict(params)
    ckpt = sd if form == "bare" else {
        "state_dict": sd, "model_kwargs": {"cond_size": 32, "gru_size": 64}}
    path = str(tmp_path / "model.pth")
    torch.save(ckpt, path)

    got = import_torch.load_torch_checkpoint(path, device="cpu")
    want = jimport_torch.load_torch_checkpoint(path)
    _assert_tree_equal(got, want)
    _assert_tree_equal(got, params)
    direct = import_torch.params_from_torch_state_dict(sd, device="cpu")
    _assert_tree_equal(direct, params)
    assert all(not t.requires_grad for t in sd.values())   # not aliased
    for quantize in (True, False):
        assert export_blob(got, quantize) == jexport_blob(want, quantize)


# -- import_tf ----------------------------------------------------------------

@pytest.fixture()
def h5py():
    return pytest.importorskip("h5py")


def test_keras_h5_round_trip(tmp_path, h5py):
    params = _seeded_params(8)
    path = str(tmp_path / "model.h5")
    write_keras_h5(h5py, path, keras_layers(params))
    got = import_tf.load_keras_checkpoint(path, device="cpu")
    _assert_tree_equal(got, jimport_tf.load_keras_checkpoint(path))
    _assert_tree_equal(got, params)


def test_keras_stand_in_group():
    """params_from_keras_h5 on the in-memory stand-in for an h5 group that
    the card's check uses where h5py is missing."""
    params = _seeded_params(8)
    group = keras_file(keras_layers(params))
    got = import_tf.params_from_keras_h5(group, device="cpu")
    _assert_tree_equal(got, jimport_tf.params_from_keras_h5(group))
    _assert_tree_equal(got, params)


def test_keras_h5_blob_export_matches_direct(tmp_path, h5py):
    params = _seeded_params(8)
    path = str(tmp_path / "model.h5")
    write_keras_h5(h5py, path, keras_layers(params))
    got = import_tf.load_keras_checkpoint(path, device="cpu")
    direct = export_blob(params_from_numpy(params, CPU))
    assert export_blob(got) == direct == jexport_blob(
        jimport_tf.load_keras_checkpoint(path))


def test_keras_h5_rejects_non_reset_after(tmp_path, h5py):
    path = str(tmp_path / "bad.h5")
    write_keras_h5(h5py, path, keras_layers(_seeded_params(8)))
    with h5py.File(path, "r+") as f:
        g = f["model_weights"]["gru1"]["gru1"]
        bias = np.asarray(g["bias:0"])[0]        # collapse to [3N]
        del g["bias:0"]
        g.create_dataset("bias:0", data=bias)
    with h5py.File(path, "r") as f:
        with pytest.raises(ValueError, match="reset_after") as port:
            import_tf.params_from_keras_h5(f, device="cpu")
        with pytest.raises(ValueError, match="reset_after") as ref:
            jimport_tf.params_from_keras_h5(f)
    assert str(port.value) == str(ref.value)


def test_keras_h5_missing_layer_message(tmp_path, h5py):
    path = str(tmp_path / "empty.h5")
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    with h5py.File(path, "r") as f:
        with pytest.raises(KeyError, match="conv1") as port:
            import_tf.params_from_keras_h5(f, device="cpu")
        with pytest.raises(KeyError, match="conv1") as ref:
            jimport_tf.params_from_keras_h5(f)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("flt", [False, True])
def test_import_tf_cli_blob(tmp_path, h5py, flt):
    params = _seeded_params(9)
    path = str(tmp_path / "model.h5")
    write_keras_h5(h5py, path, keras_layers(params))
    extra = ["--float"] if flt else []
    import_tf.main([path, str(tmp_path / "port.bin"), "--device", "cpu"]
                   + extra)
    jimport_tf.main([path, str(tmp_path / "jax.bin")] + extra)
    got = _read(tmp_path / "port.bin")
    assert got == _read(tmp_path / "jax.bin")
    assert got == export_blob(params_from_numpy(params, CPU), quantize=not flt)


# -- sweep and rir_deconv -----------------------------------------------------

def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_sweep_equals_jax():
    jspec = jsweep.SweepSpec(duration=4.0, gap=0.5, pilot_duration=0.25)
    for prop in ("nyquist", "sweep_len", "pilot_len", "gap_len",
                 "pilot_spacing"):
        assert getattr(SPEC, prop) == getattr(jspec, prop)
    _bitwise(sweep._fade_envelope(1000, 240), jsweep._fade_envelope(1000, 240))
    _bitwise(sweep.exp_sweep(SPEC), jsweep.exp_sweep(jspec))
    _bitwise(sweep.exp_sweep(SPEC, 1.5), jsweep.exp_sweep(jspec, 1.5))
    _bitwise(sweep.inverse_filter(SPEC), jsweep.inverse_filter(jspec))
    _bitwise(sweep.pilot_chirp(SPEC), jsweep.pilot_chirp(jspec))
    seq = sweep.measurement_sequence(SPEC)
    assert seq.dtype == np.int16
    _bitwise(seq, jsweep.measurement_sequence(jspec))


def test_sweep_main_writes_the_same_wav(tmp_path):
    assert sweep.main([str(tmp_path / "port.wav"), "3.0"]) == 0
    assert jsweep.main([str(tmp_path / "jax.wav"), "3.0"]) == 0
    assert _read(tmp_path / "port.wav") == _read(tmp_path / "jax.wav")
    assert sweep.main([]) == 1


@pytest.mark.parametrize("drift", [False, True])
def test_rir_deconv_equals_jax(drift):
    from scipy.signal import resample
    rng = np.random.default_rng(42)
    jspec = jsweep.SweepSpec(duration=4.0, gap=0.5, pilot_duration=0.25)
    y = record_session(sweep.measurement_sequence(SPEC), room_rir(SPEC.fs, rng),
                       rng)
    if drift:
        y = resample(y, int(round(len(y) * 1.0005)))
    assert rir_deconv.locate_pilots(y, SPEC) == jrir.locate_pilots(y, jspec)
    _bitwise(rir_deconv.extract_sweep_segment(y, SPEC),
             jrir.extract_sweep_segment(y, jspec))
    rir = rir_deconv.measure_rir(y, SPEC)
    _bitwise(rir, jrir.measure_rir(y, jspec))
    assert np.isclose(np.sum(rir ** 2), 1.0)


def test_measured_rir_feeds_feature_extraction(tmp_path, monkeypatch):
    """The chain: a recorded session -> rir_deconv.main (raw f32) ->
    -rir_list of the port's dump_features on the CPU."""
    from scipy.io import wavfile

    from rnnoise_tpu_torch.tools import dump_features as tdump
    rng = np.random.default_rng(43)
    spec = sweep.SweepSpec(duration=4.0)
    y = record_session(sweep.measurement_sequence(spec), room_rir(spec.fs, rng),
                       rng)
    pcm = np.clip(np.round(0.3 * 32767 * y), -32768, 32767)
    wavfile.write(tmp_path / "rec.wav", spec.fs, pcm.astype(np.int16))
    rir_path = tmp_path / "room.f32"
    assert rir_deconv.main([str(tmp_path / "rec.wav"), str(rir_path),
                            "4.0"]) == 0
    rir = np.fromfile(rir_path, np.float32)
    assert len(rir) > int(0.01 * spec.fs) and np.isfinite(rir).all()
    assert np.argmax(np.abs(rir)) == 0
    (tmp_path / "rirs").write_text(f"{rir_path}\n")

    n = 48000 * 6
    speech = speechlike(rng, n, f0=140.0, noise=0.02)
    for name, sig in (("speech", speech), ("noise", 2000 * rng.standard_normal(n)),
                      ("fg", np.zeros(n))):
        np.clip(sig, -32767, 32767).astype("<i2").tofile(tmp_path / f"{name}.pcm")
    calls = []
    filt = tdump.rir_filter_sequence
    monkeypatch.setattr(tdump, "rir_filter_sequence",
                        lambda a, Y: calls.append(1) or filt(a, Y))
    out = tmp_path / "features.f32"
    tdump.dump_features(*(str(tmp_path / f"{k}.pcm")
                          for k in ("speech", "noise", "fg")), str(out), 6,
                        rir_list=str(tmp_path / "rirs"), batch=6, seed=3,
                        seq_len=50, device="cpu")
    assert calls, "no sequence went through the measured RIR"
    data = np.fromfile(out, np.float32)
    assert data.size == 6 * 50 * 98
    assert np.isfinite(data).all()


# -- the examples -------------------------------------------------------------

def _run(args, cwd):
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_denoise_file_example_equals_stream_denoiser(tmp_path):
    rng = np.random.default_rng(12)
    pcm = np.clip(np.round(speechlike(rng, 50 * 480)), -32768,
                  32767).astype("<i2")
    pcm.tofile(tmp_path / "in.pcm")
    proc = _run([os.path.join(REPO, "examples", "torch_denoise_file.py"),
                 "in.pcm", "out.pcm", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    got = np.fromfile(tmp_path / "out.pcm", "<i2")

    den = StreamDenoiser(1, RNNoise.from_filename(MODEL_BLOB, device="cpu"))
    x = pcm.astype(np.float32)
    outs = [den.process_frame(x[f * 480:(f + 1) * 480])[0][0]
            for f in range(50)]
    want = np.clip(np.round(np.concatenate(outs[1:])), -32768,
                   32767).astype("<i2")
    assert got.shape == (49 * 480,)
    np.testing.assert_array_equal(got, want)


def test_streaming_server_example_runs(tmp_path):
    proc = _run([os.path.join(REPO, "examples", "torch_streaming_server.py"),
                 "8", "3", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "live streams" in proc.stdout
