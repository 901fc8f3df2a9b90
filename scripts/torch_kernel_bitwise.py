#!/usr/bin/env python3
"""Whether the standalone kernels built from this checkout give the same
outputs, bit for bit, as those built from another checkout's sources.

    python3 scripts/torch_kernel_bitwise.py --against OTHER/rnnoise_tpu_torch/csrc

Run from the repo root on a CUDA machine.  Builds rnn_step.cu, spectral.cu
and analysis.cu from both source directories in one nvcc round, then calls
each of the six standalone kernels (RNN step, forward and inverse spectra,
post-filter, lag table, analysis) through this checkout's wrappers with each
build on the same random inputs, at S=1024 and at S=37 (a ragged last
block), and prints whether every output tensor is equal.  Exits 1 if one
is not.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rnnoise_tpu_torch import kernels  # noqa: E402
from rnnoise_tpu_torch.config import resolve_device  # noqa: E402
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_xcorr, pitch  # noqa: E402
from rnnoise_tpu_torch.dsp import cuda_spectral as spec  # noqa: E402
from rnnoise_tpu_torch.models.rnn import RNNState  # noqa: E402
from rnnoise_tpu_torch.nn import cuda_rnn  # noqa: E402
from rnnoise_tpu_torch.weights.loader import load_model_file  # noqa: E402

SOURCES = {"rnn_step": (cuda_rnn,), "spectral": (spec,),
           "analysis": (cuda_xcorr, cuda_analysis)}


def flat(out):
    out = out if isinstance(out, tuple) else (out,)
    return [u for t in out for u in (t if isinstance(t, tuple) else (t,))]


def both_builds(source, fn):
    """fn() with this checkout's library, then with the other one's."""
    a = flat(fn())
    torch.cuda.synchronize()
    libs = kernels._LIBS
    libs[source], libs["other_" + source] = libs["other_" + source], libs[source]
    for mod in SOURCES[source]:
        mod._LIB = None
    try:
        b = flat(fn())
        torch.cuda.synchronize()
    finally:
        libs[source], libs["other_" + source] = libs["other_" + source], libs[source]
        for mod in SOURCES[source]:
            mod._LIB = None
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="the other checkout's rnnoise_tpu_torch/csrc")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_bitwise: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    exe = kernels.nvcc()
    kernels.compile_libraries({
        **{n: [exe, *kernels.NVCC_FLAGS, os.path.join(kernels.CSRC_DIR, n + ".cu")]
           for n in SOURCES},
        **{"other_" + n: [exe, *kernels.NVCC_FLAGS, os.path.join(a.against, n + ".cu")]
           for n in SOURCES}})
    params = load_model_file(os.path.join(REPO, "models", "rnnoise_synth_v1.blob"),
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)
    same = True
    for S in (1024, 37):
        feats = rnd(S, 65)
        st = RNNState(*(torch.tanh(rnd(S, w)) for w in (130, 256, 384, 384, 384)))
        sil = torch.rand(S, generator=g, device=dev) < 0.2
        mem, x, pbuf = rnd(S, 480, scale=3e3), rnd(S, 480, scale=3e3), rnd(S, 1728, scale=3e3)
        start = torch.randint(0, 709, (S,), generator=g, device=dev, dtype=torch.int32)
        X, P = spec.forward_spectral(mem, x, pbuf, start)
        Ex = torch.rand(S, 32, generator=g, device=dev)
        post = (X, P, Ex, *(torch.rand(S, 32, generator=g, device=dev) for _ in range(4)),
                1.3 * Ex, torch.arange(S, device=dev) % 5 == 0, rnd(S, 480))
        ds = pitch.pitch_downsample(pbuf)
        bp0, bp1 = pitch.coarse_search(ds)
        prev = torch.randint(60, 700, (S,), generator=g, device=dev, dtype=torch.int32)
        an = (mem, x, pbuf, ds, bp0, bp1, prev, torch.rand(S, generator=g, device=dev))
        for name, source, fn in (
                ("rnn_step", "rnn_step",
                 lambda: cuda_rnn.compute_rnn_step(params, st, feats, sil)),
                ("forward_spectral", "spectral",
                 lambda: spec.forward_spectral(mem, x, pbuf, start)),
                ("inverse_spectral", "spectral", lambda: spec.inverse_spectral(X)),
                ("postfilter_synthesis", "spectral",
                 lambda: spec.postfilter_synthesis(*post)),
                ("lag_corr_table", "analysis",
                 lambda: cuda_xcorr.lag_corr_table_kernel(ds)),
                ("analysis_spectral", "analysis",
                 lambda: cuda_analysis.analysis_spectral(*an))):
            ok = both_builds(source, fn)
            same = same and ok
            print(f"S={S} {name}: bitwise {'equal' if ok else 'DIFFERENT'}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
