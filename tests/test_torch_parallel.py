"""Streams and batches across devices and processes, on CPU: the sharded
processors against unsharded runs (a mesh that names the CPU twice), the
data-parallel train step in two gloo processes against one process on the
whole batch (the tolerances of tests/test_sharding.py:52-84), and the
multi-process dry run.  Every subprocess has a timeout and a file://
rendezvous under tmp_path."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch.config import ModelConfig
from rnnoise_tpu_torch.denoise import (init_state, process_frames,
                                       process_frames_tm_i16)
from rnnoise_tpu_torch.parallel import multihost, sharding
from rnnoise_tpu_torch.training.model import init_params, param_leaves
from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step
from rnnoise_tpu_torch.weights.loader import load_model_file
from tests.torch_helpers import CPU, MODEL_BLOB, REPO, make_signal

F = 480
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def params():
    return load_model_file(MODEL_BLOB, device=CPU)


def _pcm(S, T, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([make_signal(rng, T).reshape(T, F) for _ in range(S)])


def _equal(a, b):
    for x, y in zip(sharding.map_state(lambda t: t, a), b):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


def test_sharded_processor_matches_unsharded(params):
    """S=8, T=3 over two shards on the CPU, bit for bit (each stream's
    arithmetic is the same whatever the batch: the products accumulate in
    f64 and round once), from a whole state and from a sharded one."""
    mesh = sharding.make_mesh(devices=["cpu", "cpu"])
    pcm = torch.from_numpy(_pcm(8, 3).astype(np.float32))
    want = process_frames(params, init_state(8, device=CPU), pcm)
    run = sharding.make_sharded_processor(params, mesh)
    for state in (init_state(8, device=CPU), sharding.sharded_init_state(8, mesh)):
        got = run(state, pcm)
        _equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_sharded_tm_i16_processor_matches_unsharded(params):
    """The serving form: int16 [T, S, 480], streams on axis 1, chained over
    two calls."""
    mesh = sharding.make_mesh(devices=["cpu", "cpu"])
    pcm = torch.from_numpy(np.round(_pcm(8, 4, seed=1)).astype(np.int16)
                           .transpose(1, 0, 2).copy())
    run = sharding.make_sharded_processor_tm_i16(params, mesh)
    st_s = st_u = init_state(8, device=CPU)
    for c in range(2):
        st_s, out_s, vad_s = run(st_s, pcm[2 * c:2 * c + 2])
        st_u, out_u, vad_u = process_frames_tm_i16(params, st_u, pcm[2 * c:2 * c + 2])
        assert torch.equal(out_s, out_u) and torch.equal(vad_s, vad_u)
    _equal(st_s, st_u)
    with pytest.raises(ValueError):
        run(init_state(7, device=CPU), pcm[:, :7])


def test_mesh_defaults_to_the_cards():
    assert sharding.make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()


def test_multihost_single_process():
    """Without arguments or torch.distributed's variables, init_distributed
    does nothing; one process owns every row."""
    env = {k: os.environ.pop(k) for k in multihost._ENV if k in os.environ}
    try:
        multihost.init_distributed()
        assert not torch.distributed.is_initialized()
    finally:
        os.environ.update(env)
    assert multihost.process_stream_slice(8) == slice(0, 8)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = multihost.streams_from_host_local(x, CPU)
    np.testing.assert_array_equal(multihost.host_local_output(t), x)
    st = multihost.tree_from_host_local(init_state(2, device=CPU), CPU)
    assert st.pitch_buf.shape == (2, 1728)


CFG = dict(cond_size=32, gru_size=64)
B, T = 8, 24


def _batch():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1.5, (B, T, 65)).astype(np.float32),
            rng.uniform(0, 1, (B, T, 32)).astype(np.float32),
            rng.uniform(0, 1, (B, T, 1)).astype(np.float32))


_RANK = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
import torch.distributed as dist
from rnnoise_tpu_torch.config import ModelConfig
from rnnoise_tpu_torch.parallel import multihost
from rnnoise_tpu_torch.training.model import init_params, param_leaves
from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step
torch.set_num_threads(1)
CFG, B = {cfg!r}, {b}
data = np.load({data!r})

rank = int(sys.argv[1])
multihost.init_distributed({init!r}, 2, rank, "gloo")
rows = multihost.process_stream_slice(B)
assert rows == slice(4 * rank, 4 * rank + 4)
cfg = ModelConfig(**CFG)
params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
opt, sched = make_optimizer(params)
step = make_train_step(opt, sched, process_group=dist.group.WORLD)
batch = tuple(torch.from_numpy(data[k][rows]) for k in ("x", "g", "v"))
states = tuple(torch.zeros(4, cfg.gru_size) for _ in range(3))
_, m = step(params, states, batch, 0)
np.savez({out!r}.format(rank), loss=float(m["loss"]),
         **{{f"p{{i}}": t.detach().numpy() for i, t in enumerate(param_leaves(params))}})
dist.destroy_process_group()
"""


def test_data_parallel_train_step_matches_one_process(tmp_path):
    """Two gloo ranks, 4 rows each, against one process on all 8: loss
    within 1e-5, params within 1e-5."""
    np.savez(tmp_path / "batch.npz", **dict(zip(("x", "g", "v"), _batch())))
    code = _RANK.format(repo=REPO, init=f"file://{tmp_path / 'rdv'}",
                        out=str(tmp_path / "rank{}.npz"), cfg=CFG, b=B,
                        data=str(tmp_path / "batch.npz"))
    env = {k: v for k, v in os.environ.items() if k not in multihost._ENV}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    cfg = ModelConfig(**CFG)
    params = init_params(torch.Generator().manual_seed(0), cfg, CPU)
    opt, sched = make_optimizer(params)
    states = tuple(torch.zeros(B, cfg.gru_size) for _ in range(3))
    _, m = make_train_step(opt, sched)(
        params, states, tuple(torch.from_numpy(a) for a in _batch()), 0)
    want = [t.detach().numpy() for t in param_leaves(params)]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        assert abs(float(got["loss"]) - float(m["loss"])) < 1e-5
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"p{i}"], w, rtol=0, atol=1e-5)
    for i in range(len(want)):                    # the ranks agree exactly
        np.testing.assert_array_equal(ranks[0][f"p{i}"], ranks[1][f"p{i}"])


def test_dryrun_multigpu_on_cpus():
    """entry.dryrun_multigpu(2, device="cpu") in a fresh process with a
    clean environment, as test_dryrun_multichip_driver_invocation runs the
    JAX package's."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",) + multihost._ENV}
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "from rnnoise_tpu_torch import entry\n"
            "entry.dryrun_multigpu(2, device='cpu')\n"
            "print('DRYRUN_OK')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:] + res.stdout[-4000:]
    assert "DRYRUN_OK" in res.stdout
