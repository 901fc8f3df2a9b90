"""Minimal single-stream file denoiser on the PyTorch/CUDA port (the
examples/rnnoise_demo.c analogue, as library usage rather than the packaged
CLI); examples/denoise_file.py's command line plus ``--device``.

    python examples/torch_denoise_file.py in.pcm out.pcm [weights_blob.bin] \
        [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rnnoise_tpu_torch import RNNoise, StreamDenoiser  # noqa: E402
from rnnoise_tpu_torch.config import FRAME_SIZE  # noqa: E402
from rnnoise_tpu_torch.weights.registry import load_registered  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("model", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.model is not None:
        model = RNNoise.from_filename(a.model, device=a.device)
    else:
        model = RNNoise(load_registered("rnnoise_synth_v1.blob",
                                        device=a.device), device=a.device)

    den = StreamDenoiser(1, model)
    pcm = np.fromfile(a.infile, dtype="<i2").astype(np.float32)
    n = len(pcm) // FRAME_SIZE
    out = []
    first = True
    for f in range(n):
        y, vad = den.process_frame(pcm[f * FRAME_SIZE:(f + 1) * FRAME_SIZE])
        if not first:                    # drop the priming frame
            out.append(y[0])
        first = False
    np.clip(np.round(np.concatenate(out)), -32768,
            32767).astype("<i2").tofile(a.outfile)


if __name__ == "__main__":
    main()
