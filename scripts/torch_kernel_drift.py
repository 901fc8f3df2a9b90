#!/usr/bin/env python3
"""How far the port's kernel path drifts from its plain path on the card
over 150 stateful frames, for several signals, with one kernel at a time or
a configuration's kernels together.

    python3 scripts/torch_kernel_drift.py [--seeds 1 2 3] [--which f i r x a p m]

Run from the repo root on a CUDA machine.  The signals are chip_smoke.py's
(S=64, every 8th stream with a near-silent stretch), from seed 1234 + each
--seeds value; chip_smoke.py's own comparison is seed 1.  Each ``--which``
item names the kernels the kernel path launches: f = forward spectra,
i = inverse spectrum, r = RNN step, x = lag table, a = analysis, p =
post-filter, m = the whole-chunk kernel; the others run their plain
versions.  An item runs in the configuration that has its kernels
(config.CONFIGURATIONS: mono for m, fused for a and p, xcorr for x, scan
otherwise) and is held against that configuration's
plain path.  For each seed and item it prints max |PCM| (LSB) and max |VAD|
against the plain path, the final pitch periods that differ, and the frames
and streams off by more than 1 LSB.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import MODEL, SEED, signals  # noqa: E402
from rnnoise_tpu_torch.api import RNNoise  # noqa: E402
from rnnoise_tpu_torch.config import CONFIGURATIONS, resolve_device  # noqa: E402
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16  # noqa: E402
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_frame, cuda_xcorr  # noqa: E402
from rnnoise_tpu_torch.dsp import cuda_spectral as spec  # noqa: E402
from rnnoise_tpu_torch.nn import cuda_rnn  # noqa: E402

S, T = 64, 150
KERNELS = {"f": (spec, "forward_spectral", spec.forward_spectral_plain),
           "i": (spec, "inverse_spectral", spec.inverse_spectral_plain),
           "r": (cuda_rnn, "compute_rnn_step", cuda_rnn.compute_rnn_plain),
           "x": (cuda_xcorr, "lag_corr_table_kernel",
                 cuda_xcorr.lag_corr_table_plain),
           "a": (cuda_analysis, "analysis_spectral",
                 cuda_analysis.analysis_spectral_plain),
           "p": (spec, "postfilter_synthesis", spec.postfilter_synthesis_plain),
           "m": (cuda_frame, "process_chunk_monokernel",
                 cuda_frame.process_chunk_monokernel_plain)}
PATH_KERNELS = {"scan": "fir", "xcorr": "xfir", "fused": "arp", "mono": "m"}


def configuration(which):
    """The configuration whose kernels include all of ``which``."""
    for path in PATH_KERNELS:
        if set(which) <= set(PATH_KERNELS[path]):
            return path
    raise SystemExit(f"no configuration runs all of {which!r}")


def run(params, cfg, dev, pcm, path, which):
    """The kernel path of ``path`` with only the kernels in ``which``
    launched."""
    saved = {c: getattr(mod, name) for c, (mod, name, _) in KERNELS.items()}
    try:
        for c, (mod, name, plain) in KERNELS.items():
            if c not in which:
                setattr(mod, name, plain)
        st, out, vad = process_frames_tm_i16(params, init_state(S, cfg, dev), pcm,
                                             CONFIGURATIONS[path])
    finally:
        for c, (mod, name, _) in KERNELS.items():
            setattr(mod, name, saved[c])
    return st, out.int(), vad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(1, 13)))
    ap.add_argument("--which", nargs="+", default=["fir"])
    a = ap.parse_args()
    paths = {which: configuration(which) for which in a.which}
    dev = resolve_device("cuda")
    model = RNNoise.from_filename(MODEL, device=dev)
    params, cfg = model.params, model.config
    for sd in a.seeds:
        pcm = signals(S, T, dev, SEED + sd, quiet=range(0, S, 8))
        plain = {path: run(params, cfg, dev, pcm, path, "")
                 for path in sorted(set(paths.values()))}
        row = [f"seed {SEED + sd}:"]
        for which in a.which:
            sp, op, vp = plain[paths[which]]
            sk, ok, vk = run(params, cfg, dev, pcm, paths[which], which)
            d = (ok - op).abs().amax(dim=2)                 # [T, S]
            frames = (d.amax(1) > 1).nonzero().flatten().tolist()
            streams = (d.amax(0) > 1).nonzero().flatten().tolist()
            row.append(f"[{which}] PCM {int(d.max())} "
                       f"VAD {float((vk - vp).abs().max()):.1e} "
                       f"periods {int((sk.last_period != sp.last_period).sum())} "
                       f"frames>1LSB {frames[:6]} streams {streams[:6]};")
        print(" ".join(row), flush=True)


if __name__ == "__main__":
    main()
