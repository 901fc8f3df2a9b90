"""The port does all that the JAX package does, as a checkable inventory:
every public top-level function, class and upper-case constant of every
module of rnnoise_tpu/ has a counterpart of the same name in the port's
module at the same path, or an entry below that names its counterpart's
place or the reason it is dropped.  Both packages are read by AST; nothing
is imported.  ROADMAP.md (queue 1) carries the same table."""

import ast
import os

import pytest

from tests.torch_helpers import REPO

JAX = os.path.join(REPO, "rnnoise_tpu")
PORT = os.path.join(REPO, "rnnoise_tpu_torch")

# "module:name" of the JAX package -> (the port's place, what it is there).
# A place is "path" or "path:name" under rnnoise_tpu_torch/; a name may be
# "Class.field".
COUNTERPARTS = {
    "denoise.py:pitch_filter":
        ("dsp/transform.py:pitch_filter", "the comb filter, beside the other transforms"),
    "denoise.py:set_monokernel":
        ("config.py:RuntimeConfig.monokernel", "a field of the runtime configuration"),
    "dsp/biquad.py:biquad_chunk":
        ("dsp/biquad.py:biquad_frames", "the whole-chunk biquad"),
    "dsp/gather.py:take_window":
        ("dsp/cuda_spectral.py:take_window", "a plain gather"),
    "dsp/transform.py:frame_analysis":
        ("denoise.py:_frame_analysis", "the analysis step beside its caller"),
    "dsp/pallas_spectral.py:forward_spectral":
        ("dsp/cuda_spectral.py:forward_spectral", "csrc/spectral.cu"),
    "dsp/pallas_spectral.py:inverse_spectral":
        ("dsp/cuda_spectral.py:inverse_spectral", "csrc/spectral.cu"),
    "dsp/pallas_spectral.py:postfilter_synthesis":
        ("dsp/cuda_spectral.py:postfilter_synthesis", "csrc/spectral.cu"),
    "dsp/pallas_spectral.py:set_postfilter":
        ("config.py:RuntimeConfig.postfilter", "a field of the runtime configuration"),
    "dsp/pallas_spectral.py:postfilter_enabled":
        ("config.py:RuntimeConfig.postfilter", "a field of the runtime configuration"),
    "dsp/pallas_spectral.py:set_fused":
        ("config.py:CONFIGURATIONS", "the scan configuration's spectra kernels"),
    "dsp/pallas_spectral.py:fused_enabled":
        ("config.py:CONFIGURATIONS", "the scan configuration's spectra kernels"),
    "dsp/pallas_analysis.py:analysis_spectral":
        ("dsp/cuda_analysis.py:analysis_spectral", "csrc/analysis.cu"),
    "dsp/pallas_analysis.py:set_analysis":
        ("config.py:RuntimeConfig.analysis", "a field of the runtime configuration"),
    "dsp/pallas_analysis.py:analysis_enabled":
        ("config.py:RuntimeConfig.analysis", "a field of the runtime configuration"),
    "dsp/pallas_xcorr.py:lag_corr_table_pallas":
        ("dsp/cuda_xcorr.py:lag_corr_table_kernel", "csrc/analysis.cu"),
    "dsp/pallas_frame.py:process_chunk_monokernel":
        ("dsp/cuda_frame.py:process_chunk_monokernel", "csrc/frame.cu"),
    "dsp/pallas_frame.py:frame_body":
        ("csrc/frame.cu:chunk_kernel", "one frame of the chunk's loop"),
    "dsp/pallas_frame.py:FrameState":
        ("dsp/cuda_frame.py:_State", "the DenoiseState's leaves by pointer"),
    "dsp/pallas_frame.py:state_from_denoise":
        ("dsp/cuda_frame.py:_State", "the DenoiseState's leaves by pointer"),
    "dsp/pallas_frame.py:FrameConsts":
        ("dsp/cuda_frame.py:_ChunkArgs", "the launch's tables by pointer"),
    "dsp/pallas_frame.py:frame_consts":
        ("dsp/cuda_frame.py:_hp_tables", "with cuda_spectral's kernel, band and FFT tables"),
    "nn/pallas_rnn.py:compute_rnn_pallas":
        ("nn/cuda_rnn.py:compute_rnn_step", "csrc/rnn_step.cu"),
    "nn/pallas_rnn.py:PackedRNN":
        ("nn/cuda_rnn.py:PackedRNN", "nonzero 8x4 int8 blocks"),
    "nn/pallas_rnn.py:pack_params":
        ("nn/cuda_rnn.py:pack_params", "nonzero 8x4 int8 blocks"),
}

# "module:name" of the JAX package -> why the port has no counterpart.
_PERM = ("the permuted 488-wide spectrum layout, a TPU workaround ROADMAP "
         "drops: the port stores natural-order bins")
_MESH = ("a JAX mesh helper (NamedSharding over a device mesh); "
         "parallel/sharding.py's make_mesh, shard_state and shard_params "
         "split the stream axis over devices")
DROPPED = {
    "dsp/gather.py:onehot_take":
        "one-hot window extraction to avoid gathers, a TPU workaround "
        "ROADMAP drops (dsp/gather.py): the port gathers",
    "dsp/pallas_spectral.py:PERM_WIDTH": _PERM,
    "dsp/pallas_spectral.py:permute_matrix_cols": _PERM,
    "dsp/pallas_spectral.py:permute_spectrum": _PERM,
    "dsp/pallas_spectral.py:spectrum_perm": _PERM,
    "dsp/biquad.py:set_precision":
        "chooses bf16-X3 split matmuls, a TPU workaround ROADMAP drops: "
        "the port's biquad sums in f64",
    "dsp/transform.py:set_dft_mode":
        "chooses the MXU-matmul DFT over the FFT, a TPU workaround: the "
        "port's transforms are f64 products rounded once and the kernels' FFT",
    "dsp/transform.py:set_dft_precision":
        "chooses bf16-X3 split matmuls for the DFT, a TPU workaround "
        "ROADMAP drops",
    "dsp/pallas_frame.py:alias_coarse":
        "switches between two VMEM layouts of the Pallas monokernel's "
        "coarse search, a TPU workaround ROADMAP drops (VMEM limits): "
        "csrc/frame.cu has one coarse search",
    "parallel/sharding.py:STREAM_AXIS": _MESH,
    "parallel/sharding.py:stream_sharding": _MESH,
    "parallel/sharding.py:replicated": _MESH,
    "parallel/multihost.py:global_stream_mesh": _MESH,
}


def _modules(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".py"))


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def public_names(path):
    """Top-level functions, classes and upper-case constants, public."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name) and e.id.isupper():
                        out.add(e.id)
    return {n for n in out if not n.startswith("_")}


def _defined(path, name):
    """``name`` (or ``Class.field``) is defined at the top of ``path``."""
    head, _, field = name.partition(".")
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == head:
            return not field or any(
                isinstance(n, ast.AnnAssign) and n.target.id == field
                for n in node.body)
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and not field:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id == head for t in targets):
                return True
    return False


def _port_names(rel):
    path = os.path.join(PORT, rel)
    return public_names(path) if os.path.exists(path) else set()


JAX_MODULES = _modules(JAX)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port = _port_names(rel)
    missing = sorted(n for n in public_names(os.path.join(JAX, rel))
                     if n not in port and f"{rel}:{n}" not in COUNTERPARTS
                     and f"{rel}:{n}" not in DROPPED)
    assert not missing, f"{rel}: no counterpart and no entry for {missing}"


def test_entries_are_live():
    """Each entry names a public name of the JAX package that the port's
    module at the same path lacks, and sits in one table only."""
    assert not set(COUNTERPARTS) & set(DROPPED)
    for key in list(COUNTERPARTS) + list(DROPPED):
        rel, name = key.split(":")
        assert name in public_names(os.path.join(JAX, rel)), key
        assert name not in _port_names(rel), f"{key}: the port has it"
    assert all(reason.strip() for reason in DROPPED.values())


def test_counterparts_exist():
    bad = []
    for key, (place, what) in COUNTERPARTS.items():
        rel, _, name = place.partition(":")
        path = os.path.join(PORT, rel)
        if not what or not os.path.exists(path):
            bad.append(key)
        elif name and rel.endswith(".py"):
            if not _defined(path, name):
                bad.append(key)
        elif name:
            with open(path) as f:
                if name not in f.read():
                    bad.append(key)
    assert not bad, f"counterparts missing for {bad}"


def test_the_port_has_every_tool():
    """The six offline tools and the feature tool are modules of the port."""
    jax_tools = {m for m in JAX_MODULES if m.startswith("tools/")}
    assert len(jax_tools) >= 8
    assert jax_tools <= set(_modules(PORT))


# The JAX system's entry points outside its package: each file at the repo
# root and each script under scripts/ that is not the port's own
# (``torch_*``) -> (the port's counterpart, what it is there).  A place is
# a path from the repo root, or "path:name".
ENTRY_POINTS = {
    "bench.py":
        ("rnnoise_tpu_torch/bench.py", "the bench of record: chunk rows"),
    "__graft_entry__.py":
        ("rnnoise_tpu_torch/entry.py:entry", "one batched step; dryrun_multigpu"),
    "scripts/bench_engine.py":
        ("rnnoise_tpu_torch/bench.py:serve_row", "the serving tick, by stage"),
    "scripts/host_scale.py":
        ("rnnoise_tpu_torch/bench.py:host_row", "the fan-out's host tick by K"),
    "scripts/profile_pipeline.py":
        ("scripts/torch_profile.py", "torch.profiler over one chained chunk"),
    "scripts/mono_parts.py":
        ("scripts/torch_frame_phases.py", "the whole-chunk kernel by span"),
    "scripts/build_capi.sh":
        ("rnnoise_tpu_torch/capi.py:build_capi", "g++ builds the C ABI shim"),
    "scripts/dump_features_parallel.sh":
        ("scripts/torch_dump_features_parallel.sh", "the same fan-out"),
    "scripts/ci.sh":
        ("scripts/torch_ci.sh", "the port's tests, entry and dry run on CPU"),
}

# Entry points the port drops, and why.
DROPPED_ENTRY_POINTS = {
    "scripts/bench_mono.py":
        "times the Pallas monokernel's alias, frames-per-step and block "
        "variants: VMEM levers of the TPU, which csrc/frame.cu does not have",
    "scripts/probe_int8.py":
        "probes whether Mosaic lowers int8 dots to the TPU's MXU rate; the "
        "port's int8 products are mma.sync in csrc/rnn_step.cu and frame.cu",
    "scripts/prewarm.py":
        "fills JAX's persistent compile cache; the port builds its kernels "
        "with nvcc at first use in each process (kernels.py)",
    "scripts/tpu_fast_parity.py":
        "checks the TPU's bf16-X3 matmuls against f32, a TPU workaround the "
        "port drops (its sums are f32 or f64)",
}


def _jax_entry_points():
    root = {f for f in os.listdir(REPO)
            if f.endswith((".py", ".sh")) and f != "chip_smoke.py"}
    scripts = {f"scripts/{f}" for f in os.listdir(os.path.join(REPO, "scripts"))
               if f.endswith((".py", ".sh")) and not f.startswith("torch_")}
    return sorted(root | scripts)


@pytest.mark.parametrize("rel", _jax_entry_points())
def test_every_entry_point_has_a_counterpart(rel):
    assert (rel in ENTRY_POINTS) != (rel in DROPPED_ENTRY_POINTS), \
        f"{rel}: no counterpart and no reason, or both"


def test_entry_point_entries_are_live():
    points = set(_jax_entry_points())
    assert set(ENTRY_POINTS) | set(DROPPED_ENTRY_POINTS) == points
    assert all(reason.strip() for reason in DROPPED_ENTRY_POINTS.values())
    bad = []
    for key, (place, what) in ENTRY_POINTS.items():
        rel, _, name = place.partition(":")
        path = os.path.join(REPO, rel)
        if not what or not os.path.exists(path) \
                or (name and not _defined(path, name)):
            bad.append(key)
    assert not bad, f"counterparts missing for {bad}"
