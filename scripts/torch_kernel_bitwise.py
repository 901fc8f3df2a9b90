#!/usr/bin/env python3
"""The standalone kernels built from this checkout against those built from
another checkout, on the same inputs: how far their outputs are apart, and
how long each build takes.

    python3 scripts/torch_kernel_bitwise.py --against OTHER/rnnoise_tpu_torch/csrc

Run from the repo root on a CUDA machine.  Imports the other checkout's
package (the directory above its csrc/) under another name, builds both
checkouts' rnn_step.cu, spectral.cu, analysis.cu and frame.cu, and
calls each kernel (RNN step, forward and inverse spectra, post-filter, lag
table, analysis, and the whole-chunk kernel over T=20 frames) through each
checkout's own wrappers on the same random inputs, at S=1024 and at S=37 (a
ragged last block), so the two may differ in their kernels' arguments and
weight layouts.  For each it prints the elements that differ, the largest
difference in f32 ulps (over all elements, and over those above 1e-6 of
their row's maximum, where an ulp is not noise below the row's rounding)
and the largest difference relative to the row's maximum (the analysis: the
streams whose period differs, and the spectra of the others; the
whole-chunk kernel: PCM in LSB, VAD and the final periods), and at S=1024
each build's time per call (chip_smoke.gpu_time: CUDA events, the calls
back to back on the card), taken in turns (other, this, this, other).  The
analysis' own lag table and energies are compared value by value too:
through each build's ``cuda_analysis.lag_energy_table`` where it has one,
and for a build without it (whose analysis summed them in lag_partials' 4
tap slices of 120 taps, each in ascending order, the slices added as
((s0 + s1) + (s2 + s3))) through that order emulated in f64 on the card
(exact: every product is one of two floats), checked first against the
build's lag table, which sums bx in the same order.
Exits 1 if the RNN step differs at all: its arithmetic is exact (int8 dots
in s32), so no redesign may change a bit of it.
"""

import argparse
import importlib
import importlib.util
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import SEED, gpu_time, signals  # noqa: E402
import rnnoise_tpu_torch  # noqa: E402
from rnnoise_tpu_torch.config import CONFIGURATIONS, resolve_device  # noqa: E402
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16  # noqa: E402
from rnnoise_tpu_torch.dsp import pitch  # noqa: E402
from rnnoise_tpu_torch.models.rnn import RNNState  # noqa: E402
from rnnoise_tpu_torch.weights.loader import load_model_file  # noqa: E402

MODULES = ("kernels", "nn.cuda_rnn", "dsp.cuda_spectral", "dsp.cuda_xcorr",
           "dsp.cuda_analysis", "dsp.cuda_frame")
STRICT = ("rnn_step",)


def package_modules(name):
    """{module: the module} of an imported copy of the port."""
    return {m.rsplit(".", 1)[-1]: importlib.import_module(f"{name}.{m}") for m in MODULES}


def import_other(csrc):
    """The other checkout's package, imported as other_rnnoise_tpu_torch."""
    pkg = os.path.dirname(os.path.abspath(csrc))
    name = "other_rnnoise_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return package_modules(name)


def flat(out):
    out = out if isinstance(out, tuple) else (out,)
    return [u for t in out for u in (t if isinstance(t, tuple) else (t,))]


def ulps(a, b):
    """|a - b| in f32 ulps, elementwise (a and b f32 of one shape)."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()


def float_diff(xs, ys):
    """(elements differing, their count, largest ulp difference, largest
    ulp difference among elements above 1e-6 of their row's maximum,
    largest |difference| / row maximum) over pairs of f32 tensors."""
    n = tot = 0
    worst = big = 0
    rel = 0.0
    for x, y in zip(xs, ys):
        x2, y2 = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
        u = ulps(x2, y2)
        top = y2.abs().amax(1, keepdim=True).clamp(min=1e-30)
        n += int((u > 0).sum())
        tot += u.numel()
        worst = max(worst, int(u.max()) if u.numel() else 0)
        sel = u[y2.abs() >= 1e-6 * top]
        big = max(big, int(sel.max()) if sel.numel() else 0)
        rel = max(rel, float(((x2 - y2).abs() / top).max()) if u.numel() else 0.0)
    return (f"{n} of {tot} elements differ, by at most {worst} ulp ({big} ulp above "
            f"1e-6 of the row's maximum, {rel:.2e} of the row's maximum)"), n == 0


def slice_order_tables(ds):
    """bx, yy [S, 385] f32 of ds [S, 864] summed in lag_partials' order: per
    slice of 120 taps, in ascending order, then ((s0 + s1) + (s2 + s3)), in
    f64 and rounded once."""
    d = ds.double()
    x, win = d[:, 384:], d.unfold(1, 385, 1)          # win[s, j, i] = d[s, i + j]
    acc = torch.zeros(d.shape[0], 4, 385, dtype=torch.float64, device=d.device)
    en = torch.zeros_like(acc)
    for j in range(120):
        jj = 120 * torch.arange(4, device=d.device) + j
        w = win[:, jj, :]
        acc = acc + x[:, jj, None] * w
        en = en + w * w
    return tuple(((t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])).float() for t in (acc, en))


def lag_tables(mods, ds):
    """(bx, yy, how) of a build's analysis for ds."""
    an = mods["cuda_analysis"]
    if hasattr(an, "lag_energy_table"):
        return (*an.lag_energy_table(ds), "its lag_energy_table")
    bx, yy = slice_order_tables(ds)
    same = torch.equal(bx, mods["cuda_xcorr"].lag_corr_table_kernel(ds))
    return bx, yy, f"lag_partials' order emulated (bx equal to its lag table: {same})"


def compare(name, a, b):
    """(summary text, equal) of this build's outputs a against the other's."""
    if name == "analysis_spectral":
        X, P, T0, gain = a
        oX, oP, oT0, ogain = b
        same = T0 == oT0
        text, equal = float_diff((X[same], P[same], gain[same, None]),
                                 (oX[same], oP[same], ogain[same, None]))
        return (f"T0 differs in {int((~same).sum())} of {len(T0)} streams; over the "
                f"others, of X, P and gain: {text}"), equal and bool(same.all())
    if name == "process_chunk_monokernel":
        st, out, vad = a
        ost, oout, ovad = b
        pcm = int((out.int() - oout.int()).abs().max())
        per = int((st.last_period != ost.last_period).sum())
        dv = float((vad - ovad).abs().max())
        return (f"PCM {int((out != oout).sum())} of {out.numel()} samples differ, by at "
                f"most {pcm} LSB; VAD by at most {dv:.3e}; {per} final periods differ"), \
            pcm == 0 and per == 0 and dv == 0.0
    return float_diff(flat(a), flat(b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="the other checkout's rnnoise_tpu_torch/csrc")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_bitwise: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    mine = package_modules(rnnoise_tpu_torch.__name__)
    other = import_other(a.against)
    for mods in (mine, other):
        mods["kernels"].build_kernels()
    params = load_model_file(os.path.join(REPO, "models", "rnnoise_synth_v1.blob"),
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)
    strict_ok = True
    for S in (1024, 37):
        feats = rnd(S, 65)
        st = RNNState(*(torch.tanh(rnd(S, w)) for w in (130, 256, 384, 384, 384)))
        sil = torch.rand(S, generator=g, device=dev) < 0.2
        mem, x, pbuf = rnd(S, 480, scale=3e3), rnd(S, 480, scale=3e3), rnd(S, 1728, scale=3e3)
        mem[0], x[0], pbuf[0] = 1e-4 * mem[0], 1e-4 * x[0], 1e-4 * pbuf[0]
        start = torch.randint(0, 709, (S,), generator=g, device=dev, dtype=torch.int32)
        X, P = mine["cuda_spectral"].forward_spectral(mem, x, pbuf, start)
        Ex = torch.rand(S, 32, generator=g, device=dev)
        post = (X, P, Ex, *(torch.rand(S, 32, generator=g, device=dev) for _ in range(4)),
                1.3 * Ex, torch.arange(S, device=dev) % 5 == 0, rnd(S, 480))
        # the analysis' inputs from a real decimation and coarse search
        seq = signals(S, 5, dev, SEED + 3, quiet=range(0, S, 16)).float()
        seq = seq.transpose(0, 1).reshape(S, -1)
        buf = seq[:, -1728:].contiguous()
        ds = pitch.pitch_downsample(buf)
        bp0, bp1 = pitch.coarse_search(ds)
        prev = torch.randint(60, 700, (S,), generator=g, device=dev, dtype=torch.int32)
        an = (buf[:, -960:-480].contiguous(), buf[:, -480:].contiguous(), buf, ds,
              bp0, bp1, prev, torch.rand(S, generator=g, device=dev))
        pcm = signals(S, 30, dev, SEED + 4, quiet=range(0, S, 16))
        warm, _, _ = process_frames_tm_i16(params, init_state(S, device=dev), pcm[:10],
                                           CONFIGURATIONS["fused"])
        chunk = pcm[10:].contiguous()
        ours, theirs = lag_tables(mine, ds), lag_tables(other, ds)
        torch.cuda.synchronize()
        print(f"S={S} analysis lag table and energies: this build {ours[2]}, other "
              f"build {theirs[2]}; bx: {float_diff([ours[0]], [theirs[0]])[0]}; yy: "
              f"{float_diff([ours[1]], [theirs[1]])[0]}", flush=True)
        for name, fn in (
                ("rnn_step",
                 lambda m: m["cuda_rnn"].compute_rnn_step(params, st, feats, sil)),
                ("forward_spectral",
                 lambda m: m["cuda_spectral"].forward_spectral(mem, x, pbuf, start)),
                ("inverse_spectral", lambda m: m["cuda_spectral"].inverse_spectral(X)),
                ("postfilter_synthesis",
                 lambda m: m["cuda_spectral"].postfilter_synthesis(*post)),
                ("lag_corr_table",
                 lambda m: m["cuda_xcorr"].lag_corr_table_kernel(ds)),
                ("analysis_spectral",
                 lambda m: m["cuda_analysis"].analysis_spectral(*an)),
                ("process_chunk_monokernel",
                 lambda m: m["cuda_frame"].process_chunk_monokernel(params, warm, chunk))):
            ours, theirs = fn(mine), fn(other)
            torch.cuda.synchronize()
            text, equal = compare(name, ours, theirs)
            if name in STRICT:
                strict_ok = strict_ok and equal
                text += " (must be bitwise equal)"
            print(f"S={S} {name}: {text}", flush=True)
            if S == 1024:
                reps = 5 if name == "process_chunk_monokernel" else 20
                t_o = [gpu_time(lambda: fn(other), reps)]
                t_m = [gpu_time(lambda: fn(mine), reps), gpu_time(lambda: fn(mine), reps)]
                t_o.append(gpu_time(lambda: fn(other), reps))
                print(f"S={S} {name}: other build {sum(t_o) / 2:.4f} ms ({t_o[0]:.4f}, "
                      f"{t_o[1]:.4f}), this build {sum(t_m) / 2:.4f} ms ({t_m[0]:.4f}, "
                      f"{t_m[1]:.4f})", flush=True)
    print("strict kernels bitwise equal" if strict_ok
          else "STRICT KERNELS DIFFER", flush=True)
    return 0 if strict_ok else 1


if __name__ == "__main__":
    sys.exit(main())
