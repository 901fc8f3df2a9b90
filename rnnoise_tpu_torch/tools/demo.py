"""rnnoise_demo equivalent (reference examples/rnnoise_demo.c:33-69) — the
counterpart of ``rnnoise_tpu/tools/demo.py``, with the same command line
plus ``--device``:

    python -m rnnoise_tpu_torch.tools.demo [--model weights_blob.bin] \\
        [--streams N] [--chunk-frames T] [--device cuda|cpu] \\
        <in.pcm> <out.pcm>

Raw 48 kHz mono 16-bit PCM in and out.  Like the C demo, the first output
frame is dropped (the pipeline primes its lookahead).  ``--streams N``
processes the same file as N independent streams (a throughput
demonstration); the output is stream 0.  The default model is the
registered ``models/rnnoise_synth_v1.blob`` (sha256-pinned); the device is
the GPU unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..api import RNNoise, StreamDenoiser
from ..config import DEFAULT_MODEL, FRAME_SIZE
from ..weights.registry import load_registered


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None,
                   help="weights_blob.bin (default: the registered model)")
    p.add_argument("--streams", type=int, default=1)
    p.add_argument("--chunk-frames", type=int, default=16,
                   help="frames per device dispatch")
    p.add_argument("--device", default="cuda")
    p.add_argument("infile")
    p.add_argument("outfile")
    args = p.parse_args(argv)

    if not os.path.exists(args.infile):
        p.error(f"input file not found: {args.infile}")
    if args.model:
        model = RNNoise.from_filename(args.model, device=args.device)
    else:
        model = RNNoise(load_registered(device=args.device), DEFAULT_MODEL,
                        device=args.device)

    den = StreamDenoiser(args.streams, model)
    pcm = np.fromfile(args.infile, dtype="<i2").astype(np.float32)
    n_frames = len(pcm) // FRAME_SIZE
    pcm = pcm[: n_frames * FRAME_SIZE].reshape(n_frames, FRAME_SIZE)

    out = np.empty_like(pcm)
    T = args.chunk_frames
    for i in range(0, n_frames, T):
        chunk = pcm[i:i + T]                                # [t, 480]
        batch = np.broadcast_to(chunk[None], (args.streams,) + chunk.shape)
        res, _ = den.process_chunk(np.ascontiguousarray(batch))
        out[i:i + T] = res[0]

    # first frame dropped, mirroring the C demo (rnnoise_demo.c:57)
    flat = out.reshape(-1)[FRAME_SIZE:]
    np.clip(np.round(flat), -32768, 32767).astype("<i2").tofile(args.outfile)
    print(f"processed {n_frames} frames x {args.streams} streams on "
          f"{den.device}", file=sys.stderr)


if __name__ == "__main__":
    main()
