#!/usr/bin/env python3
"""How far the port drifts from the JAX package over 150 stateful frames on
CPU, in each of the HP biquad's state roundings ("f64", the default, and
"xla_cpu", as the JAX package's CPU graph rounds it), beside the JAX
package's own drift between batch sizes.

    RNNT_CACHE_DIR=0 python3 scripts/torch_parity_drift.py [--seeds 0 1 2]

Run from the repo root (it imports both packages and tests/).  For each
seed: 4 streams of the parity tests' signal recipe through
rnnoise_tpu.denoise.process_frames and the port's process_frames_tm_i16;
prints max |PCM| (LSB) and max |VAD| differences for (a) the port with the
"xla_cpu" state rounding, (b) the port with the "f64" one, (c) JAX at S=4
against JAX run one stream at a time.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rnnoise_tpu import denoise as jd  # noqa: E402
from rnnoise_tpu.weights.loader import load_model_file  # noqa: E402
from rnnoise_tpu_torch import denoise as td  # noqa: E402
from rnnoise_tpu_torch.dsp import biquad as tbq  # noqa: E402
from rnnoise_tpu_torch.weights.loader import params_from_numpy  # noqa: E402
from tests.torch_helpers import MODEL_BLOB, make_signal  # noqa: E402


def round_i16(out):
    out = np.asarray(out)
    return np.clip(np.trunc(np.where(out > 0, out + .5, out - .5)),
                   -32768, 32767).astype(np.int64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1])
    a = ap.parse_args()
    jp = load_model_file(MODEL_BLOB)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    run = jax.jit(lambda s, x: jd.process_frames(jp, s, x))
    S, T = 4, 150
    for seed in a.seeds:
        rng = np.random.default_rng(seed)
        pcm = np.stack([make_signal(rng, T) for _ in range(S)])
        pcm = np.clip(np.round(pcm), -32768, 32767).reshape(S, T, 480)
        _, jo, jv = run(jd.init_state(S), jnp.asarray(pcm.astype(np.float32)))
        jo, jv = round_i16(jo), np.asarray(jv)
        row = [f"seed {seed}:"]
        for mode in ("xla_cpu", "f64"):
            old = tbq.set_state_rounding(mode)
            _, to, tv = td.process_frames_tm_i16(
                tp, td.init_state(S, device="cpu"),
                torch.from_numpy(pcm.transpose(1, 0, 2).astype(np.int16)))
            tbq.set_state_rounding(old)
            row.append(f"port, {mode} state: PCM "
                       f"{np.abs(jo - to.numpy().transpose(1, 0, 2)).max()} "
                       f"VAD {np.abs(jv - tv.numpy().T).max():.2e};")
        one = [run(jd.init_state(1), jnp.asarray(pcm[s:s + 1].astype(np.float32)))
               for s in range(S)]
        o1 = np.concatenate([round_i16(o) for _, o, _ in one])
        v1 = np.concatenate([np.asarray(v) for _, _, v in one])
        row.append(f"JAX S=4 vs S=1: PCM {np.abs(jo - o1).max()} "
                   f"VAD {np.abs(jv - v1).max():.2e}")
        print(" ".join(row), flush=True)


if __name__ == "__main__":
    main()
