#!/bin/sh
# The port's CI entry point, the counterpart of scripts/ci.sh, on the CPU:
# the port's tests (they hold it against the JAX package, which they
# import), one batched step of entry.entry() and the two-process dry run of
# the multi-device paths on gloo (entry.dryrun_multigpu).
#
# usage: scripts/torch_ci.sh
set -e
cd "$(dirname "$0")/.."

RNNT_CACHE_DIR=0 python -m pytest tests/test_torch_*.py -q -p no:cacheprovider

python - <<'PY'
from rnnoise_tpu_torch import entry

fn, (state, pcm) = entry.entry(device="cpu")
state, out, vad = fn(state, pcm)
assert out.shape == pcm.shape and vad.shape == pcm.shape[:2], (out.shape, vad.shape)
entry.dryrun_multigpu(2, device="cpu")
print("entry + dryrun_multigpu OK")
PY
