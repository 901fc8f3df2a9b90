"""Many-stream serving example on the PyTorch/CUDA port: the native
StreamingEngine with dynamic attach/detach, simulating thousands of
concurrent callers on one card; examples/streaming_server.py's command line
plus ``--device``.

    python examples/torch_streaming_server.py [n_slots] [n_ticks] \
        [--device cuda]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rnnoise_tpu_torch import RNNoise  # noqa: E402
from rnnoise_tpu_torch.config import FRAME_SIZE  # noqa: E402
from rnnoise_tpu_torch.runtime.engine import StreamingEngine  # noqa: E402
from rnnoise_tpu_torch.weights.registry import load_registered  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_slots", nargs="?", type=int, default=64)
    ap.add_argument("n_ticks", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    n_slots, n_ticks = a.n_slots, a.n_ticks
    chunk = 8

    model = RNNoise(load_registered("rnnoise_synth_v1.blob", device=a.device),
                    device=a.device)
    eng = StreamingEngine(n_slots, model, chunk_frames=chunk)

    rng = np.random.default_rng(0)
    slots = [eng.attach() for _ in range(n_slots // 2)]   # start half-full
    t0 = time.perf_counter()
    frames_done = 0
    for tick in range(n_ticks):
        # simulate arrivals/departures
        if tick % 5 == 1 and len(slots) < n_slots:
            slots.append(eng.attach())
        if tick % 7 == 3 and len(slots) > 1:
            eng.detach(slots.pop(0))
        # feed audio
        for s in slots:
            eng.push(s, (3000 * rng.standard_normal(chunk * FRAME_SIZE)
                         ).astype(np.int16))
        frames_done += eng.tick() * chunk
    dt = time.perf_counter() - t0
    audio_sec = frames_done * FRAME_SIZE / 48000.0
    print(f"{len(slots)} live streams; {frames_done} frames "
          f"({audio_sec:.1f} s audio) in {dt:.2f} s "
          f"-> {audio_sec / dt:.1f}x realtime aggregate")
    for s in slots[:3]:
        got = eng.pull(s, 4 * FRAME_SIZE)
        print(f"slot {s}: pulled {len(got)} denoised samples")


if __name__ == "__main__":
    main()
