"""The port's bench: realtime 48 kHz streams per card, the serving tick and
the host's fan-out, one JSON line per row and one last line.

    python -m rnnoise_tpu_torch.bench                  # every row, on the card
    python -m rnnoise_tpu_torch.bench --rows chunk:mono:1024:100 serve:pipelined:1024:8
    python -m rnnoise_tpu_torch.bench --device cpu --rows chunk:mono:4:2

The counterpart of the repo's ``bench.py`` (chunk rows),
``scripts/bench_engine.py`` (serving rows) and ``scripts/host_scale.py``
(host rows) in one command.  A row is named by a spec:

* ``chunk:<path>:<S>:<T>`` -- chained ``denoise.process_frames_tm_i16``
  calls on S streams of T frames in the kernel configuration ``path`` of
  ``config.CONFIGURATIONS``, the registered model, int16 PCM made from
  ``--seed``; the median call after one warm-up, calls longer than 3x the
  median dropped; then the last chunk again for its first 8 streams, from
  the same state, through the kernels and through their plain versions,
  held to PCM 4 LSB and VAD 2e-3 (``correct``).
* ``serve:<plain|pipelined>:<S>:<T>`` -- ``StreamingEngine`` ticks; the
  pool fed one chunk before each tick and drained after (neither timed);
  median, 90th percentile and count; a plain row also splits the tick into
  its five stages, the card synchronised after each.
* ``host:<S>:<T>:<K>`` -- ``FanoutPool`` with K worker processes and an
  identity device step: push, assemble, commit and pull, timed together.

Each row runs in a child process of its own (``--one <spec>``) whose last
stdout line is the row's JSON; the orchestrator prints each row's line as it
comes, mirrors the running summary to ``--out`` (default
``_build/bench_partial.json`` in this package) and prints the summary as the
last line.  A row's child is stopped after ``RNNT_TORCH_BENCH_ROW_TIMEOUT``
seconds (default 900).  SIGTERM or SIGINT stops the running child and
prints the summary of the rows done.  The kernels a row needs are built
before its first call (``build_s``) and that call is timed apart
(``first_call_s``); neither is in the row's figures.  Exit code: 0 when
every row reported and every chunk row was correct, 1 otherwise (the last
line is printed either way), 2 without a CUDA device when ``--device`` is
``cuda`` (nothing is printed on stdout then).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from . import kernels
from .api import RNNoise
from .config import CONFIGURATIONS, FRAME_SIZE, resolve_device
from .denoise import init_state, map_state, process_frames_tm_i16
from .dsp import cuda_analysis, cuda_frame, cuda_spectral, cuda_xcorr
from .nn import cuda_rnn
from .runtime import native
from .runtime.engine import StreamingEngine
from .runtime.fanout import FanoutPool
from .weights.registry import load_registered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TIMEOUT_ENV = "RNNT_TORCH_BENCH_ROW_TIMEOUT"
ROW_TIMEOUT_S = 900.0
STOP_GRACE_S = 20.0          # a stopped child's time to release what it holds

# The rows in the order they run: the shipping configuration (mono) first.
ROWS = (
    "chunk:mono:1024:100", "chunk:mono:2048:100", "chunk:mono:4096:100",
    "chunk:mono:1024:8", "chunk:mono:4096:8",
    "chunk:fused:1024:100", "chunk:xcorr:1024:100", "chunk:scan:1024:100",
    "serve:plain:1024:8", "serve:pipelined:1024:8",
    "serve:plain:4096:8", "serve:pipelined:4096:8",
    "host:4096:8:1", "host:4096:8:2", "host:4096:8:4",
)
# the row whose tick the last line carries
TICK_ROW = "serve:pipelined:1024:8"

# the kernel libraries each configuration launches (kernels.KERNEL_SOURCES)
LIBRARIES = {
    "scan": ("rnn_step", "spectral"),
    "xcorr": ("rnn_step", "spectral", "analysis"),
    "fused": ("rnn_step", "spectral", "analysis"),
    "mono": ("frame",),
}
SLOW_CALLS, MONO_CALLS = 10, 30      # timed chunk calls after one warm-up
DROP_FACTOR = 3.0                    # calls longer than 3x the median dropped
CHECK_STREAMS = 8                    # streams of the kernel-vs-plain check
PCM_LSB, VAD_TOL = 4, 2e-3           # its budget (chip_smoke.py phase 3)
TICKS, WARMUP = 50, 3                # serving and host ticks
TICK_STAGES = ("assemble", "to_device", "device", "to_host", "commit")
HOST_RING_FRAMES = 64                # host rows' rings (scripts/host_scale.py)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; a wrapper counts its launches."""
    return {"rnn_step": cuda_rnn.compute_rnn_step,
            "forward_spectral": cuda_spectral.forward_spectral,
            "inverse_spectral": cuda_spectral.inverse_spectral,
            "lag_corr_table": cuda_xcorr.lag_corr_table_kernel,
            "analysis_spectral": cuda_analysis.analysis_spectral,
            "postfilter_synthesis": cuda_spectral.postfilter_synthesis,
            "process_chunk_monokernel": cuda_frame.process_chunk_monokernel}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def parse_spec(spec: str):
    """``spec`` -> (kind, args); raises ValueError on a malformed one."""
    kind, *rest = spec.split(":")
    try:
        if kind == "chunk" and len(rest) == 3 and rest[0] in CONFIGURATIONS:
            return kind, (rest[0], int(rest[1]), int(rest[2]))
        if kind == "serve" and len(rest) == 3 and rest[0] in ("plain", "pipelined"):
            return kind, (rest[0], int(rest[1]), int(rest[2]))
        if kind == "host" and len(rest) == 3:
            return kind, tuple(int(v) for v in rest)
    except ValueError:
        pass
    raise ValueError(f"bad row spec {spec!r}: want chunk:<path>:<S>:<T>, "
                     "serve:<plain|pipelined>:<S>:<T> or host:<S>:<T>:<K>")


def device_record(device: torch.device) -> dict:
    """The device a figure was taken on: for CUDA the card's name and power
    limit as nvidia-smi gives them, and the card count; the torch build."""
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None,
                "count": 1, **rec}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, _, limit = smi[device.index or 0].rpartition(", ")
    return {"platform": "gpu", "kind": name, "power_limit": limit,
            "count": torch.cuda.device_count(), **rec}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(device: torch.device, names, streamio: bool = False) -> float:
    """Build the named kernel libraries (and the native stream pool) now,
    so that no row's first call builds; returns the seconds taken."""
    t0 = time.perf_counter()
    if device.type == "cuda" and names:
        kernels.build_kernels(names)
    if streamio:
        native.get_lib()
    return time.perf_counter() - t0


def noise_i16(rng, shape) -> np.ndarray:
    """int16 PCM: 3000 x standard normal, through f32, truncated."""
    return (3000 * rng.standard_normal(shape)).astype(np.float32).astype(np.int16)


def out_digest(out: torch.Tensor, vad: torch.Tensor) -> str:
    """sha256 of a chunk's int16 output and f32 VAD as stored."""
    h = hashlib.sha256(out.cpu().numpy().tobytes())
    h.update(vad.cpu().numpy().tobytes())
    return h.hexdigest()


def check_slice(params, state, pcm: torch.Tensor, rt, n: int = CHECK_STREAMS):
    """The chunk ``pcm`` from ``state`` for its first ``n`` streams, through
    the kernels and through their plain versions: (PCM max |diff| in LSB,
    VAD max |diff|)."""
    st = map_state(lambda t: t[:n].contiguous(), state)
    x = pcm[:, :n].contiguous()
    _, out_k, vad_k = process_frames_tm_i16(params, st, x, rt)
    _, out_p, vad_p = process_frames_tm_i16(params, st, x, rt, plain=True)
    return (int((out_k.int() - out_p.int()).abs().max()),
            float((vad_k - vad_p).abs().max()))


def chunk_row(path: str, S: int, T: int, device: torch.device, seed: int) -> dict:
    rt = CONFIGURATIONS[path]
    build_s = build(device, LIBRARIES[path])
    params = load_registered(device=device)
    pcm = torch.from_numpy(noise_i16(np.random.default_rng(seed),
                                     (T, S, FRAME_SIZE))).to(device)
    state = init_state(S, device=device)
    t0 = time.perf_counter()
    state, out, vad = process_frames_tm_i16(params, state, pcm, rt)
    sync(device)
    float(vad.sum())
    first_call_s = time.perf_counter() - t0

    zero_launches()
    times = []
    for _ in range(SLOW_CALLS if path in ("fused", "xcorr", "scan") else MONO_CALLS):
        before = state
        t0 = time.perf_counter()
        state, out, vad = process_frames_tm_i16(params, state, pcm, rt)
        sync(device)
        checksum = float(vad.sum())      # a host read of the call's result
        times.append(time.perf_counter() - t0)
        if not np.isfinite(checksum):
            raise RuntimeError(f"{path}: VAD not finite")
    launches = read_launches()
    med = float(np.median(times))
    kept = [t for t in times if t <= DROP_FACTOR * med]
    pcm_err, vad_err = check_slice(params, before, pcm, rt)
    audio = S * T * FRAME_SIZE / 48000.0
    return {
        "S": S, "T": T, "path": path,
        "streams": audio / med, "ms_frame": 1e3 * med / T,
        "n_runs": len(kept), "streams_min": audio / max(kept),
        "streams_max": audio / min(kept), "first_call_s": first_call_s,
        "build_s": build_s, "median_ms": 1e3 * med,
        "min_ms": 1e3 * min(kept), "max_ms": 1e3 * max(kept),
        "calls": len(times), "dropped": len(times) - len(kept),
        "launches": launches, "out_sha256": out_digest(out, vad),
        "pcm_err": pcm_err, "vad_err": vad_err,
        "correct": pcm_err <= PCM_LSB and vad_err <= VAD_TOL,
    }


def time_ticks(eng, block: np.ndarray, n: int, stages: bool = False):
    """Seconds of each of ``n`` ticks after WARMUP, the pool fed ``block``
    [S, T*480] before each tick and its output rings drained after (neither
    timed).  A pipelined tick returns before the card is done: the
    synchronise after the last tick is timed and its share added to each
    tick.  With ``stages`` the tick runs stage by stage (plain), the card
    synchronised after each, and each stage's seconds are returned too."""
    T, dev = eng.chunk_frames, eng.device
    drain = np.empty((eng.n_slots, T * FRAME_SIZE), np.int16)
    ticks, parts = [], {k: [] for k in TICK_STAGES}
    for i in range(WARMUP + n):
        eng.pool.push_all(block)
        t0 = time.perf_counter()
        if not stages:
            eng.tick()
            t = [time.perf_counter()]
        else:
            batch, counts, reset = eng._assemble(T)
            t = [time.perf_counter()]
            args = eng._to_device(batch, counts, reset)
            sync(dev)
            t.append(time.perf_counter())
            out = eng._compute(*args)
            sync(dev)
            t.append(time.perf_counter())
            host = eng._to_host(out)
            t.append(time.perf_counter())
            eng._commit(T, host, counts)
            t.append(time.perf_counter())
        eng.pool.pull_all(T * FRAME_SIZE, out=drain)
        if i >= WARMUP:
            ticks.append(t[-1] - t0)
            for k, a, b in zip(TICK_STAGES, [t0] + t[:-1], t):
                parts[k].append(b - a)
    t0 = time.perf_counter()
    sync(dev)
    share = (time.perf_counter() - t0) / n
    eng.flush()
    eng.pool.pull_all(T * FRAME_SIZE, out=drain)
    return [t + share for t in ticks], (parts if stages else None)


def serve_row(mode: str, S: int, T: int, device: torch.device, seed: int) -> dict:
    build_s = build(device, LIBRARIES["mono"], streamio=True)
    model = RNNoise(load_registered(device=device), device=device)
    eng = StreamingEngine(S, model, chunk_frames=T, ring_frames=4 * T,
                          pipelined=mode == "pipelined", device=device)
    if sum(eng.attach() >= 0 for _ in range(S)) != S:
        raise RuntimeError("attach")
    block = noise_i16(np.random.default_rng(seed), (S, T * FRAME_SIZE))
    drain = np.empty((S, T * FRAME_SIZE), np.int16)
    eng.pool.push_all(block)
    t0 = time.perf_counter()
    eng.tick()
    eng.flush()
    sync(device)
    first_call_s = time.perf_counter() - t0
    eng.pool.pull_all(T * FRAME_SIZE, out=drain)

    zero_launches()
    ticks, _ = time_ticks(eng, block, TICKS)
    launches = read_launches()
    med = float(np.median(ticks))
    audio = S * T * FRAME_SIZE / 48000.0
    row = {"S": S, "T": T, "mode": mode, "tick_ms": 1e3 * med,
           "tick_p90_ms": 1e3 * float(np.percentile(ticks, 90)),
           "tick_min_ms": 1e3 * min(ticks), "tick_max_ms": 1e3 * max(ticks),
           "n_ticks": len(ticks), "streams": audio / med,
           "first_call_s": first_call_s, "build_s": build_s,
           "launches": launches, "host_cores": os.cpu_count()}
    if mode == "plain":
        _, parts = time_ticks(eng, block, TICKS, stages=True)
        row["stages_ms"] = {k: 1e3 * float(np.median(v)) for k, v in parts.items()}
    return row


def host_row(S: int, T: int, K: int, device: torch.device, seed: int) -> dict:
    n = T * FRAME_SIZE
    pcm = noise_i16(np.random.default_rng(seed), (S, 4 * n))
    t0 = time.perf_counter()
    pool = FanoutPool(S, K, ring_frames=HOST_RING_FRAMES, t_max=T,
                      io_cap_frames=4 * T)
    build_s = time.perf_counter() - t0
    try:
        pool.attach_all()
        out = np.empty((S, n), np.int16)

        def tick(x):
            pool.push_all(x)
            batch, _, _ = pool.assemble_tm_i16(T)
            pool.commit_tm_i16(T, batch)      # the identity device step
            pool.pull_all(n, out=out)

        t0 = time.perf_counter()
        tick(pcm)                              # fills the rings 4 chunks deep
        first_call_s = time.perf_counter() - t0
        times = []
        for i in range(WARMUP + TICKS):
            t0 = time.perf_counter()
            tick(pcm[:, :n])
            if i >= WARMUP:
                times.append(time.perf_counter() - t0)
    finally:
        pool.close()
    med = float(np.median(times))
    return {"S": S, "T": T, "workers": K, "tick_ms": 1e3 * med,
            "tick_min_ms": 1e3 * min(times), "tick_max_ms": 1e3 * max(times),
            "n_ticks": len(times),
            "host_realtime_streams": S * n / 48000.0 / med,
            "first_call_s": first_call_s, "build_s": build_s,
            "host_cores": os.cpu_count()}


def _exit_on_signal(signum, frame):
    # unwinds through the row's finally blocks: a fan-out pool's close()
    # stops its workers and unlinks its shared memory
    sys.exit(128 + signum)


def run_one(spec: str, device: str, seed: int) -> int:
    """A child: run one row and print its JSON as the last stdout line."""
    signal.signal(signal.SIGTERM, _exit_on_signal)
    kind, args = parse_spec(spec)
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    run = {"chunk": chunk_row, "serve": serve_row, "host": host_row}[kind]
    row = {"row": spec, "kind": kind, **run(*args, device=dev, seed=seed),
           "seed": seed, "device": device_record(dev)}
    print(json.dumps(row), flush=True)
    return 0


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

class Stopped(Exception):
    """SIGTERM or SIGINT reached the orchestrator."""


def _raise_stopped(signum, frame):
    raise Stopped(signum)


def stop_child(proc) -> None:
    """SIGTERM, then SIGKILL after STOP_GRACE_S; reaps the child."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=STOP_GRACE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def summary(rows: list, failed: list, device: dict, seed: int) -> dict:
    """The last line: bench.py's schema without ``vs_baseline`` (no TPU
    figure sets a target here), plus correctness, the device and the
    pipelined tick at S=1024."""
    chunks = [r for r in rows if r["kind"] == "chunk"]
    good = [r for r in chunks if r["correct"]]
    best = max(good, key=lambda r: r["streams"], default={})
    tick = next((r for r in rows if r["row"] == TICK_ROW), {})
    return {
        # a CPU run's figure is not a card's
        "metric": ("realtime_streams_per_chip" if device["platform"] == "gpu"
                   else "realtime_streams_on_cpu"),
        "value": best.get("streams", 0.0), "unit": "streams",
        "path": best.get("path", "none"), "row": best.get("row"),
        "n_runs": best.get("n_runs", 0),
        "streams_min": best.get("streams_min", 0.0),
        "streams_max": best.get("streams_max", 0.0),
        "configs_run": len(rows), "rows_failed": list(failed),
        "correct": len(good) == len(chunks),
        "tick_ms": tick.get("tick_ms"), "tick_p90_ms": tick.get("tick_p90_ms"),
        "host_cores": os.cpu_count(), "seed": seed, "device": device,
    }


def run_row(spec: str, argv: list, timeout: float, current: list):
    """Run one child, kept in ``current[0]`` while it runs; its last stdout
    line parsed, or None (logged) when it failed, overran ``timeout`` or
    printed no JSON."""
    proc = current[0] = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                         text=True, cwd=REPO)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_child(proc)
        log(f"{spec}: row timeout after {timeout} s")
        return None
    if proc.returncode != 0:
        log(f"{spec}: child failed, exit {proc.returncode}")
        return None
    try:
        row = json.loads(out.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        log(f"{spec}: no JSON from the child ({e})")
        return None
    if row.get("row") != spec:
        log(f"{spec}: the child reported row {row.get('row')!r}")
        return None
    return row


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m rnnoise_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", nargs="+", default=list(ROWS), metavar="SPEC",
                    help="row specs, in order (default: every row)")
    ap.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                  "bench_partial.json"),
                    help="where the running summary is mirrored")
    ap.add_argument("--one", metavar="SPEC", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, child=None) -> int:
    """Run the rows, each in a child started as ``child`` (an argv prefix
    that takes ``--one SPEC --device D --seed N``; default this module)."""
    args = parse_args(argv)
    if args.one:
        return run_one(args.one, args.device, args.seed)
    for spec in args.rows:
        parse_spec(spec)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("bench: no CUDA device (pass --device cpu to run the plain "
            "versions on the CPU)")
        return 2
    dev_rec = device_record(device)
    log(f"bench: {dev_rec['kind']}, {dev_rec['power_limit']}, torch "
        f"{dev_rec['torch']}, cuda {dev_rec['cuda']}, {len(args.rows)} rows")
    child = list(child or [sys.executable, "-m", "rnnoise_tpu_torch.bench"])
    timeout = float(os.environ.get(ROW_TIMEOUT_ENV, ROW_TIMEOUT_S))
    rows, failed, current = [], [], [None]
    signal.signal(signal.SIGTERM, _raise_stopped)
    signal.signal(signal.SIGINT, _raise_stopped)
    try:
        for spec in args.rows:
            t0 = time.perf_counter()
            row = run_row(spec, child + ["--one", spec, "--device", args.device,
                                         "--seed", str(args.seed)],
                          timeout, current)
            if row is None:
                failed.append(spec)
                continue
            rows.append(row)
            print(json.dumps(row), flush=True)
            log(f"{spec}: {time.perf_counter() - t0:.1f} s wall, build "
                f"{row['build_s']:.1f} s, first call {row['first_call_s']:.2f} s")
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(json.dumps(summary(rows, failed, dev_rec, args.seed)) + "\n")
    except Stopped as e:
        log(f"bench: stopped by signal {e.args[0]} after {len(rows)} rows")
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        if current[0] is not None:
            stop_child(current[0])
    last = summary(rows, failed, dev_rec, args.seed)
    print(json.dumps(last), flush=True)
    return 0 if last["correct"] and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
