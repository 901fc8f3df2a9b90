"""The port's training stack (rnnoise_tpu_torch/training/) against the JAX
package's on CPU: the sequence model and its gradients, the loss, the
sparsifier, AdamW with its schedule, the train step, the blob and C
exports, and the checkpoint round trip.  Inputs are made with numpy from a
seed and handed to both packages; params carry across as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.config import ModelConfig as JModelConfig
from rnnoise_tpu.training import c_export as jc_export
from rnnoise_tpu.training import export as jexport
from rnnoise_tpu.training import loss as jloss
from rnnoise_tpu.training import model as jmodel
from rnnoise_tpu.training import sparsify as jsparsify
from rnnoise_tpu.training import train as jtrain
from rnnoise_tpu_torch.config import ModelConfig
from rnnoise_tpu_torch.training import c_export, export, loss, model
from rnnoise_tpu_torch.training import sparsify, train
from rnnoise_tpu_torch.weights.loader import load_model_bytes
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401

SMALL = dict(cond_size=16, gru_size=32)
B, T = 3, 40


def _jax_params(seed=0, **sizes):
    return jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(seed), JModelConfig(**(sizes or SMALL))))


def _batch(seed=1, b=B, t=T):
    """features [b, t, 65], gain [b, t, 32] (some -1: don't care),
    vad [b, t, 1] in {0, 1}, states 3 x [b, N]."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1.5, (b, t, 65)).astype(np.float32)
    gain = rng.uniform(0, 1, (b, t, 32)).astype(np.float32)
    gain[rng.random((b, t, 32)) < 0.2] = -1.0
    vad = (rng.random((b, t, 1)) < 0.6).astype(np.float32)
    states = tuple((0.5 * rng.standard_normal((b, SMALL["gru_size"])))
                   .astype(np.float32) for _ in range(3))
    return feats, gain, vad, states


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_jax(remat, monkeypatch):
    """Gains, VAD and the three GRU states within 1e-5 abs, with and
    without the segmented recompute (segments of 16 steps here, so that T=40
    crosses two segment boundaries)."""
    monkeypatch.setattr(model, "REMAT_SEGMENT", 16)
    jp = _jax_params()
    feats, _, _, states = _batch()
    jg, jv, js = jmodel.forward(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(feats),
                                tuple(map(jnp.asarray, states)), remat=remat)
    tg, tv, ts = model.forward(model.params_from_numpy(jp, "cpu"), _t(feats),
                               tuple(map(_t, states)), remat=remat)
    assert tg.shape == (B, T - 4, 32) and tv.shape == (B, T - 4, 1)
    for a, b in zip((jg, jv, *js), (tg, tv, *ts)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5)


def test_gradients_match_jax(monkeypatch):
    """d loss / d params, through the recomputed segments, against jax.grad:
    each leaf within 1e-4 of its largest absolute value (+1e-7)."""
    monkeypatch.setattr(model, "REMAT_SEGMENT", 16)
    jp = _jax_params()
    feats, gain, vad, states = _batch()

    def jloss_of(p):
        pg, pv, _ = jmodel.forward(p, jnp.asarray(feats),
                                   tuple(map(jnp.asarray, states)), remat=True)
        return jloss.rnnoise_loss(pg, pv, jnp.asarray(gain)[:, 3:-1],
                                  jnp.asarray(vad)[:, 3:-1])[0]
    jgrads = jax.grad(jloss_of)(jax.tree.map(jnp.asarray, jp))

    tp = model.params_from_numpy(jp, "cpu")
    pg, pv, _ = model.forward(tp, _t(feats), tuple(map(_t, states)), remat=True)
    loss.rnnoise_loss(pg, pv, _t(gain)[:, 3:-1], _t(vad)[:, 3:-1])[0].backward()
    for layer in jp:
        for name in jp[layer]:
            want = np.asarray(jgrads[layer][name])
            got = tp[layer][name].grad.numpy()
            tol = 1e-4 * np.abs(want).max() + 1e-7
            assert np.abs(got - want).max() <= tol, (layer, name)


def test_loss_and_mask_match_jax():
    """The loss and both its parts within 1e-6 rel; the mask exactly."""
    rng = np.random.default_rng(5)
    pg = rng.uniform(0.01, 0.99, (B, T, 32)).astype(np.float32)
    pv = rng.uniform(0.01, 0.99, (B, T, 1)).astype(np.float32)
    _, gain, vad, _ = _batch(6)
    want = jloss.rnnoise_loss(*map(jnp.asarray, (pg, pv, gain, vad)))
    got = loss.rnnoise_loss(*map(_t, (pg, pv, gain, vad)))
    for a, b in zip((want[0], *want[1]), (got[0], *got[1])):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    np.testing.assert_array_equal(loss.mask(_t(gain)).numpy(),
                                  np.asarray(jloss.mask(jnp.asarray(gain))))


@pytest.mark.parametrize("step", [5999, 6000, 6050, 6100, 13000, 20000, 25000])
def test_sparsify_step_matches_jax_bitwise(step):
    """The sparsified params (and so the block masks) bit for bit, on and
    off the schedule, at GRU width 64 (16 x 8 blocks a gate)."""
    jp = _jax_params(3, cond_size=16, gru_size=64)
    want = jax.tree.map(np.asarray, jsparsify.sparsify_step(
        jax.tree.map(jnp.asarray, jp), step))
    tp = model.params_from_numpy(jp, "cpu")
    ran = sparsify.sparsify_step(tp, step)
    assert ran == (step not in (5999, 6050))
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_array_equal(
                tp[layer][name].detach().numpy(), want[layer][name],
                err_msg=f"{layer}.{name}")
    # at 6000 the ramp keeps every block; from 6100 some go
    w = tp["gru1"]["w_in"].detach().numpy()
    assert (w == 0).any() == (step >= 6100)


def test_optimizer_matches_optax():
    """The same 5 gradients through AdamW with its schedule: params within
    1e-6 rel of optax.adamw's, relative to the leaf's largest absolute
    value before or after the steps (lr 1e-2 and decay 0.1, so that the
    schedule moves visibly within the 5 steps).  The two round the
    decoupled decay and the step in another order, so an element whose
    updates cancel to near zero differs in the last bits of its operands."""
    jp = _jax_params()
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32), jp) for _ in range(5)]
    jopt = jtrain.make_optimizer(lr=1e-2, lr_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    tp = model.params_from_numpy(jp, "cpu")
    opt, sched = train.make_optimizer(tp, lr=1e-2, lr_decay=0.1)
    import optax
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for layer in g:
            for name in g[layer]:
                tp[layer][name].grad = _t(g[layer][name])
        opt.step()
        sched.step()
    for layer in jp:
        for name in jp[layer]:
            want = np.asarray(jparams[layer][name])
            got = tp[layer][name].detach().numpy()
            scale = max(np.abs(want).max(), np.abs(jp[layer][name]).max())
            assert np.abs(got - want).max() <= 1e-6 * scale, (layer, name)


def test_train_steps_match_jax():
    """3 sparse steps from step 6000 (the first sparsifies) from the same
    params, batch and states: the loss within 1e-4 rel at each step; 99.9 %
    of param elements within 1e-5 abs and all within 2 * lr * steps (Adam's
    first steps turn a near-zero gradient's sign flip into a full lr)."""
    jp = _jax_params(4)
    feats, gain, vad, states = _batch(8)
    jopt = jtrain.make_optimizer()
    jstep = jtrain.make_train_step(jopt, sparse=True)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate, jst = jopt.init(jparams), tuple(map(jnp.asarray, states))
    tp = model.params_from_numpy(jp, "cpu")
    opt, sched = train.make_optimizer(tp)
    tstep = train.make_train_step(opt, sched, sparse=True)
    tst = tuple(map(_t, states))
    jbatch = tuple(map(jnp.asarray, (feats, gain, vad)))
    tbatch = tuple(map(_t, (feats, gain, vad)))
    for step in range(6000, 6003):
        jparams, jstate, jst, jm = jstep(jparams, jstate, jst, jbatch,
                                         jnp.asarray(step, jnp.int32))
        tst, tm = tstep(tp, tst, tbatch, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    diff = np.concatenate([
        np.abs(tp[layer][name].detach().numpy()
               - np.asarray(jparams[layer][name])).ravel()
        for layer in jp for name in jp[layer]])
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= 2 * 1e-3 * 3, diff.max()
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_export_blob_byte_identical(quantize, sparse):
    """export_blob of the same params (as initialised, or sparsified at step
    20000) gives the JAX package's bytes; the quantised blob loads into the
    port's loader with the params' float weights.  (A float-only blob has no
    conv2 int8 array, which both packages' loaders require.)"""
    jp = _jax_params(9)
    if sparse:
        jp = jax.tree.map(np.asarray, jsparsify.sparsify_step(
            jax.tree.map(jnp.asarray, jp), 20000))
    tp = model.params_from_numpy(jp, "cpu")
    blob = export.export_blob(tp, quantize)
    assert blob == jexport.export_blob(jp, quantize)
    if quantize:
        mp = load_model_bytes(blob, ModelConfig(**SMALL), device="cpu")
        np.testing.assert_array_equal(mp.dense_out.weights_f32.numpy(),
                                      jp["dense_out"]["w"])
        assert mp.gru2_recurrent.weights_q is not None


@pytest.mark.parametrize("quantize", [False, True])
def test_emit_c_identical(tmp_path, quantize):
    """emit_c writes the JAX package's two files, character for character."""
    jp = _jax_params(10)
    c_export.emit_c(model.params_from_numpy(jp, "cpu"), str(tmp_path / "t"),
                    ModelConfig(**SMALL), quantize=quantize)
    jc_export.emit_c(jp, str(tmp_path / "j"), JModelConfig(**SMALL),
                     quantize=quantize)
    for name in ("rnnoise_data.c", "rnnoise_data.h"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def test_checkpoint_resume(tmp_path):
    """save_checkpoint then load_checkpoint gives the params exactly and the
    step; train() resumed from it starts a fresh optimizer state, as the
    JAX package resumes (its optax state restarts at count 0)."""
    cfg = ModelConfig(**SMALL)
    tp = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt, sched = train.make_optimizer(tp)
    step_fn = train.make_train_step(opt, sched)
    feats, gain, vad, states = _batch(11)
    step_fn(tp, tuple(map(_t, states)), tuple(map(_t, (feats, gain, vad))), 0)
    path = str(tmp_path / "c.ckpt")
    train.save_checkpoint(path, tp, opt, 17, cfg, 0.5)
    blob, lp = train.load_checkpoint(path, "cpu")
    assert blob["step"] == 17 and blob["model_kwargs"] == SMALL
    assert blob["opt_state"]["state"], "the optimizer state was saved"
    for layer in tp:
        for name in tp[layer]:
            assert torch.equal(lp[layer][name], tp[layer][name].detach())
            assert lp[layer][name].requires_grad

    # resume: 1 epoch of 1 batch from the checkpoint
    data = np.concatenate([feats, np.maximum(gain, -1), vad], axis=-1)
    data.astype(np.float32).tofile(tmp_path / "f.f32")
    args = train.build_argparser().parse_args([
        str(tmp_path / "f.f32"), str(tmp_path / "out"), "--device", "cpu",
        "--sequence-length", str(T), "--batch-size", str(B), "--epochs", "1",
        "--cond-size", "16", "--gru-size", "32",
        "--initial-checkpoint", path])
    train.train(args)
    after = torch.load(str(tmp_path / "out" / "checkpoints" / "rnnoise_1.ckpt"),
                       weights_only=True)
    assert after["step"] == 18
    # a fresh AdamW state after one update has step count 1
    assert all(float(s["step"]) == 1.0
               for s in after["opt_state"]["state"].values())
