"""The port's training-data path (denoise._frame_analysis,
training/features.py, training/augment.py, tools/dump_features.py) against
the JAX package's on CPU, from the same numpy inputs and the same numpy
random streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu import denoise as jd
from rnnoise_tpu.tools import dump_features as jdump
from rnnoise_tpu.training import augment as jaugment
from rnnoise_tpu.training import features as jfeatures
from rnnoise_tpu_torch import denoise as td
from rnnoise_tpu_torch.tools import dump_features as tdump
from rnnoise_tpu_torch.training import augment, features
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401

B, T = 2, 60
LOWPASS = np.array([481, 150], np.int32)     # the second stream lowpassed


def _re_im(X):
    X = np.asarray(X)
    return np.concatenate([X.real, X.imag], axis=-1)


def _row_err(a, b):
    """max over rows of max|a - b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.maximum(np.abs(b).max(-1), 1e-30)
    return float((np.abs(a - b).max(-1) / den).max())


def test_frame_analysis_matches_jax():
    """X and its band energies within 1e-4 of each row's maximum, the bins
    at and above the lowpass bin zero, the new memory the frame itself."""
    rng = np.random.default_rng(0)
    mem = (3000 * rng.standard_normal((B, 480))).astype(np.float32)
    x = (3000 * rng.standard_normal((B, 480))).astype(np.float32)
    jm, jX, jE = jd._frame_analysis(jnp.asarray(mem), jnp.asarray(x),
                                    jnp.asarray(LOWPASS))
    tm, tX, tE = td._frame_analysis(torch.from_numpy(mem), torch.from_numpy(x),
                                    torch.from_numpy(LOWPASS))
    assert torch.equal(tm, torch.from_numpy(x))
    assert _row_err(tX.numpy(), _re_im(jX)) <= 1e-4
    assert _row_err(tE.numpy(), jE) <= 1e-4
    assert not tX[1, 150:481].any() and not tX[1, 481 + 150:].any()


@pytest.fixture(scope="module")
def sequences():
    """clean [B, T*480] speech-like PCM and noisy = clean + noise, with a
    near-silent stretch in the second stream."""
    rng = np.random.default_rng(42)
    n = T * 480
    clean = np.stack([speechlike(rng, n, f0=f0, noise=0.02)
                      for f0 in (120.0, 190.0)])
    noisy = clean + (300 * rng.standard_normal(clean.shape)).astype(np.float32)
    for a in (clean, noisy):
        a[1, 20 * 480:30 * 480] *= 1e-4
    return clean.astype(np.float32), noisy.astype(np.float32)


def test_sequence_features_match_jax(sequences):
    """Ey and Ex within 1e-4 of each row's maximum, silence identical, the
    features within 1e-3 abs but for the pitch feature (index 64) on frames
    whose period flips, at most 2 per 120 frames (the parity budget)."""
    clean, noisy = sequences
    want = [np.asarray(a) for a in jfeatures._sequence_features(
        jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(LOWPASS))]
    got = [a.numpy() for a in features._sequence_features(
        torch.from_numpy(clean), torch.from_numpy(noisy),
        torch.from_numpy(LOWPASS))]
    Ey, Ex, feats, silence = got
    assert Ey.shape == (B, T, 32) and feats.shape == (B, T, 65)
    assert _row_err(Ey.reshape(-1, 32), want[0].reshape(-1, 32)) <= 1e-4
    assert _row_err(Ex.reshape(-1, 32), want[1].reshape(-1, 32)) <= 1e-4
    np.testing.assert_array_equal(silence, want[3])
    assert silence[1].any() and not silence.all()
    flips = feats[..., 64] != want[2][..., 64]
    assert flips.sum() <= 2 * B * T // 120, int(flips.sum())
    assert np.abs(feats[..., :64] - want[2][..., :64]).max() <= 1e-3
    assert np.abs(feats[..., 64] - want[2][..., 64])[~flips].max() <= 1e-3


def test_compute_targets_and_band_lp_match_jax():
    """compute_targets (every don't-care rule taken) and
    band_lp_from_lowpass give the JAX package's arrays exactly."""
    rng = np.random.default_rng(3)
    Ey = rng.exponential(1.0, (3, 50, 32)).astype(np.float32)
    Ex = (Ey + rng.exponential(0.5, Ey.shape)).astype(np.float32)
    Ey[:, :5] *= 1e-3
    silence = rng.random((3, 50)) < 0.1
    vad = (rng.random((3, 50)) < 0.5).astype(np.int32)
    lowpass = np.array([481, 37, 200], np.int32)
    band_lp = features.band_lp_from_lowpass(lowpass)
    np.testing.assert_array_equal(band_lp,
                                  jfeatures.band_lp_from_lowpass(lowpass))
    noise_free = np.array([False, True, False])
    np.testing.assert_array_equal(
        features.compute_targets(Ey, Ex, silence, vad, band_lp, noise_free),
        jfeatures.compute_targets(Ey, Ex, silence, vad, band_lp, noise_free))


def test_rir_helpers_match_jax(tmp_path):
    """load_rir_list and rir_filter_sequence give the JAX package's arrays
    exactly (a 600-sample response, so the early taper applies)."""
    rng = np.random.default_rng(4)
    rir = (np.exp(-np.arange(600) / 100.0) * rng.standard_normal(600))
    rir.astype(np.float32).tofile(tmp_path / "r.f32")
    (tmp_path / "list").write_text(f"{tmp_path / 'r.f32'}\n")
    got = features.load_rir_list(str(tmp_path / "list"))
    want = jfeatures.load_rir_list(str(tmp_path / "list"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    audio = (3000 * rng.standard_normal(40000)).astype(np.float32)
    np.testing.assert_array_equal(
        features.rir_filter_sequence(audio, got.rir[0]),
        jfeatures.rir_filter_sequence(audio, want.rir[0]))


@pytest.mark.parametrize("name", ["rand_filt", "rand_resp", "viterbi_vad",
                                  "clear_vad", "weighted_rms",
                                  "weighted_rms_fast", "generate_sequence"])
def test_augmentation_matches_jax(name):
    """Each augmentation function, and a whole augmented sequence, from
    the same numpy random stream gives the JAX package's result exactly."""
    E = np.random.default_rng(5).exponential(1e6, 300)
    E[100:140] *= 1e-6
    vad = jaugment.viterbi_vad(E)
    pcm = (3000 * np.random.default_rng(6).standard_normal(300 * 480)
           ).astype(np.float32)
    corpus = [(np.random.default_rng(k).standard_normal(200000) * 3000)
              .astype(np.int16) for k in (7, 8, 9)]
    calls = {
        "rand_filt": lambda m, rng: m.rand_filt(rng),
        "rand_resp": lambda m, rng: m.rand_resp(rng),
        "viterbi_vad": lambda m, rng: m.viterbi_vad(E),
        "clear_vad": lambda m, rng: m.clear_vad(pcm, vad),
        "weighted_rms": lambda m, rng: m.weighted_rms(pcm[:20000]),
        "weighted_rms_fast": lambda m, rng: m.weighted_rms_fast(pcm),
        "generate_sequence": lambda m, rng: m.generate_sequence(
            rng, *corpus, None, seq_len=300),
    }
    mods = ((augment, jaugment) if name != "generate_sequence"
            else (tdump, jdump))
    for seed in range(8):
        got = calls[name](mods[0], np.random.default_rng(seed))
        want = calls[name](mods[1], np.random.default_rng(seed))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)
    if name == "viterbi_vad":
        assert 0 < vad.sum() < len(vad)
