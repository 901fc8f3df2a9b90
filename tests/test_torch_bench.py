"""The port's bench (``python -m rnnoise_tpu_torch.bench``) on the CPU, at
S=4, T=2, where every wrapper runs its kernel's plain version: the rows
and the last line parse, the last line keeps the root bench.py's schema
(read by AST, never imported), a chunk row's output is the chained
``process_frames_tm_i16`` output bit for bit, and a failed, overrun,
wrong or signalled run still ends in a parsed last line."""

import ast
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch import bench, kernels
from rnnoise_tpu_torch.config import CONFIGURATIONS, FRAME_SIZE
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
from rnnoise_tpu_torch.weights.registry import load_registered
from tests.torch_helpers import REPO

ROWS = ["chunk:mono:4:2", "chunk:scan:4:2", "host:8:2:2"]
RUN_TIMEOUT_S = 300

# A stand-in program for the bench's children: it runs bench.main with
# itself as the child, and in the child plants a fault named by MODE.
PLANTED = """
import sys
sys.path.insert(0, {repo!r})
import torch
from rnnoise_tpu_torch import bench

MODE = {mode!r}
if "--one" in sys.argv:
    if MODE == "exit":
        sys.exit(3)
    if MODE == "wrong":
        real = bench.process_frames_tm_i16

        def wrong(params, state, pcm, rt, plain=False):
            state, out, vad = real(params, state, pcm, rt, plain)
            return state, out if plain else out + 50, vad
        bench.process_frames_tm_i16 = wrong
sys.exit(bench.main(sys.argv[1:], child=[sys.executable, __file__]))
"""


def _bench(args, env=None, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "rnnoise_tpu_torch.bench",
                           *args], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=RUN_TIMEOUT_S)


def _planted(tmp_path, mode, args, env=None):
    script = tmp_path / f"planted_{mode}.py"
    script.write_text(PLANTED.format(repo=REPO, mode=mode))
    return subprocess.run([sys.executable, str(script), *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=RUN_TIMEOUT_S)


def _lines(stdout):
    return [json.loads(ln) for ln in stdout.strip().splitlines()]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The bench on the CPU: two chunk rows and a host row."""
    out = tmp_path_factory.mktemp("bench") / "partial.json"
    before = _digest(os.path.join(REPO, "BENCH_partial.json"))
    res = _bench(["--device", "cpu", "--rows", *ROWS, "--out", str(out)])
    after = _digest(os.path.join(REPO, "BENCH_partial.json"))
    return res, _lines(res.stdout), out, before == after


def test_every_row_and_the_last_line_parse(run):
    res, lines, out, _ = run
    assert res.returncode == 0, res.stderr[-3000:]
    rows, last = lines[:-1], lines[-1]
    assert [r["row"] for r in rows] == ROWS
    assert [r["kind"] for r in rows] == ["chunk", "chunk", "host"]
    for r in rows:
        assert r["device"]["platform"] == "cpu" and r["device"]["torch"]
        assert r["build_s"] >= 0 and r["first_call_s"] >= 0
    for r in rows[:2]:
        assert r["correct"] and r["pcm_err"] == 0 and r["vad_err"] == 0.0
        assert r["n_runs"] + r["dropped"] == r["calls"] >= 10
        assert r["streams_min"] <= r["streams"] <= r["streams_max"]
        # on CPU tensors the wrappers run the plain versions: no launch
        assert not any(r["launches"].values())
    assert rows[2]["workers"] == 2 and rows[2]["n_ticks"] == bench.TICKS
    assert last["configs_run"] == 3 and last["correct"] is True
    assert last["rows_failed"] == [] and last["host_cores"] == os.cpu_count()
    assert last["value"] == max(r["streams"] for r in rows[:2])
    assert last["device"]["platform"] == "cpu"
    assert last["metric"] == "realtime_streams_on_cpu"
    assert json.loads(out.read_text()) == last


def _best_json_keys():
    """The keys bench.py's best_json writes, read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "best_json")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_last_line_keeps_the_root_bench_schema(run):
    keys = _best_json_keys()
    assert {"metric", "value", "unit", "vs_baseline", "configs_run",
            "attribution_file"} <= keys
    last = run[1][-1]
    missing = keys - {"vs_baseline", "attribution_file"} - set(last)
    assert not missing, missing
    assert "vs_baseline" not in last
    assert {"correct", "device", "tick_ms", "tick_p90_ms"} <= set(last)


def test_chunk_row_is_the_chained_call_bit_for_bit(run):
    row = run[1][0]
    S, T, seed = row["S"], row["T"], row["seed"]
    params = load_registered(device="cpu")
    rng = np.random.default_rng(seed)
    pcm = torch.from_numpy((3000 * rng.standard_normal((T, S, FRAME_SIZE)))
                           .astype(np.float32).astype(np.int16))
    state = init_state(S, device="cpu")
    for _ in range(1 + row["calls"]):     # the warm-up, then the timed calls
        state, out, vad = process_frames_tm_i16(params, state, pcm,
                                                CONFIGURATIONS[row["path"]])
    digest = hashlib.sha256(out.numpy().tobytes() + vad.numpy().tobytes())
    assert row["out_sha256"] == digest.hexdigest()


def test_nothing_is_written_at_the_repo_root(run):
    assert run[3], "BENCH_partial.json changed"
    assert os.path.dirname(bench.parse_args([]).out) == kernels.BUILD_DIR


def test_failed_child_still_prints_the_last_line(tmp_path):
    res = _planted(tmp_path, "exit", ["--device", "cpu", "--rows",
                                      "chunk:mono:4:2", "--out",
                                      str(tmp_path / "p.json")])
    assert res.returncode == 1, res.stderr[-3000:]
    last = _lines(res.stdout)[-1]
    assert last["configs_run"] == 0 and last["value"] == 0.0
    assert last["rows_failed"] == ["chunk:mono:4:2"]
    assert "child failed, exit 3" in res.stderr


def test_row_timeout_still_prints_the_last_line(tmp_path):
    env = dict(os.environ, **{bench.ROW_TIMEOUT_ENV: "0.01"})
    res = _bench(["--device", "cpu", "--rows", "chunk:mono:4:2", "--out",
                  str(tmp_path / "p.json")], env=env)
    assert res.returncode == 1, res.stderr[-3000:]
    lines = _lines(res.stdout)
    assert len(lines) == 1
    assert lines[0]["configs_run"] == 0 and lines[0]["path"] == "none"
    assert "row timeout" in res.stderr


def test_planted_wrong_output_fails_the_run(tmp_path):
    res = _planted(tmp_path, "wrong", ["--device", "cpu", "--rows",
                                       "chunk:mono:4:2", "--out",
                                       str(tmp_path / "p.json")])
    assert res.returncode == 1, res.stderr[-3000:]
    row, last = _lines(res.stdout)
    assert row["correct"] is False and row["pcm_err"] > bench.PCM_LSB
    assert last["correct"] is False and last["configs_run"] == 1
    assert last["value"] == 0.0 and last["path"] == "none"


def test_sigterm_after_the_first_row_prints_the_last_line(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "rnnoise_tpu_torch.bench", "--device", "cpu",
         "--rows", "chunk:scan:4:2", "chunk:mono:4:2", "chunk:mono:4:2",
         "--out", str(tmp_path / "p.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        first = json.loads(proc.stdout.readline())
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert first["row"] == "chunk:scan:4:2"
    assert proc.returncode == 0, err[-3000:]
    last = _lines(rest)[-1]
    assert last["configs_run"] >= 1 and last["correct"] is True
    assert "stopped by signal" in err


def test_no_card_and_no_cpu_flag_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _bench(["--rows", "chunk:mono:4:2", "--out", str(tmp_path / "p.json")])
    assert res.returncode == 2 and res.stdout == ""
    assert not (tmp_path / "p.json").exists()


@pytest.mark.parametrize("spec", bench.ROWS)
def test_default_rows_parse(spec):
    kind, args = bench.parse_spec(spec)
    assert kind in ("chunk", "serve", "host") and len(args) == 3


def test_default_rows_lead_with_the_shipping_configuration():
    from rnnoise_tpu_torch.config import DEFAULT_RUNTIME
    kind, (path, _, _) = bench.parse_spec(bench.ROWS[0])
    assert kind == "chunk" and CONFIGURATIONS[path] == DEFAULT_RUNTIME
    assert bench.TICK_ROW in bench.ROWS
    assert set(bench.LIBRARIES) == set(CONFIGURATIONS)
    assert {lib for libs in bench.LIBRARIES.values() for lib in libs} \
        == set(kernels.KERNEL_SOURCES)


@pytest.mark.parametrize("spec", ["chunk:nope:4:2", "serve:fast:4:2",
                                  "host:4:2", "chunk:mono:four:2", "disk:1:2:3"])
def test_bad_row_specs_are_refused(spec):
    with pytest.raises(ValueError, match="bad row spec"):
        bench.parse_spec(spec)
