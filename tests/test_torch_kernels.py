"""Every kernel wrapper launches on its tensors' device: it makes that device
the current one around the launch (the launch and cudaFuncSetAttribute
apply to the current device) and passes that device's current stream.

One card cannot show a launch on the wrong device, so this runs on the CPU:
the compiled libraries are replaced by recorders, ``torch.cuda.device`` and
``torch.cuda.current_stream`` by stubs, and the input tensors are CPU
tensors that report themselves as CUDA ones.  The current device is
another one than the tensors', so a wrapper that took the current stream
instead of its tensors' would pass the wrong one."""

import contextlib
import glob
import os
import re

import pytest
import torch

from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.denoise import init_state
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_frame, cuda_spectral
from rnnoise_tpu_torch.dsp import cuda_xcorr
from rnnoise_tpu_torch.models.rnn import RNNState
from rnnoise_tpu_torch.nn import cuda_rnn
from rnnoise_tpu_torch.weights.loader import load_model_file
from tests.torch_helpers import MODEL_BLOB, OnCuda

CURRENT_STREAM = 1000        # the stream of the (other) current device


def _stream_of(device):
    return 2000 + len(str(device))


class _Recorder:
    """Stands in for a compiled library: records each launch function's
    name, the device current when it was called and its stream argument."""

    def __init__(self, entered):
        self.entered, self.calls, self.n_args = entered, [], {}

    def __getattr__(self, name):
        def launch(*args):
            stream = args[-1].value if args[-1] is not None else None
            self.calls.append((name, list(self.entered), stream))
            self.n_args[name] = len(args)
            return 0
        return launch


@pytest.fixture
def recorded(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        try:
            yield
        finally:
            entered.pop()

    class Stream:
        def __init__(self, value):
            self.cuda_stream = value

    def current_stream(device=None):
        return Stream(CURRENT_STREAM if device is None else _stream_of(device))

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    lib = _Recorder(entered)
    for mod in (cuda_rnn, cuda_spectral, cuda_xcorr, cuda_analysis, cuda_frame):
        monkeypatch.setattr(mod, "_LIB", lib)
    return lib


def _cuda(t):
    return t.as_subclass(OnCuda)


def _launch_all(recorded):
    """Every wrapper's CUDA branch once, on CPU tensors; returns the launch
    functions' names in call order."""
    params = load_model_file(MODEL_BLOB, device="cpu")
    g = torch.Generator().manual_seed(0)
    S = 3
    rnd = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    i32 = torch.zeros(S, dtype=torch.int32)
    st = RNNState(*(rnd(S, w) for w in (130, 256, 384, 384, 384)))
    sil = torch.zeros(S, dtype=torch.bool)
    X, P = rnd(S, 962), rnd(S, 962)
    b32 = [rnd(S, 32) for _ in range(6)]
    pcm = torch.zeros((2, S, 480), dtype=torch.int16)
    calls = {
        "rnnt_rnn_step": lambda: cuda_rnn.compute_rnn_step(
            params, st, _cuda(rnd(S, 65)), sil),
        "rnnt_forward_spectral": lambda: cuda_spectral.forward_spectral(
            rnd(S, 480), _cuda(rnd(S, 480)), rnd(S, 1728), i32),
        "rnnt_inverse_spectral": lambda: cuda_spectral.inverse_spectral(_cuda(X)),
        "rnnt_postfilter_synthesis": lambda: cuda_spectral.postfilter_synthesis(
            _cuda(X), P, *b32, sil, rnd(S, 480)),
        "rnnt_lag_corr_table": lambda: cuda_xcorr.lag_corr_table_kernel(
            _cuda(rnd(S, 864))),
        "rnnt_analysis_spectral": lambda: cuda_analysis.analysis_spectral(
            rnd(S, 480), _cuda(rnd(S, 480)), rnd(S, 1728), rnd(S, 864), i32,
            i32, i32, rnd(S)),
        "rnnt_lag_energy_table": lambda: cuda_analysis.lag_energy_table(
            _cuda(rnd(S, 864))),
        "rnnt_process_chunk": lambda: cuda_frame.process_chunk_monokernel(
            params, init_state(S, device="cpu"), _cuda(pcm)),
    }
    for call in calls.values():
        call()
    return list(calls)


def test_wrappers_launch_on_their_tensors_device(recorded):
    names = _launch_all(recorded)
    cpu = torch.device("cpu")
    assert [c[0] for c in recorded.calls] == names
    for name, entered, stream in recorded.calls:
        assert entered == [cpu], f"{name} launched with {entered} current"
        assert stream == _stream_of(cpu) != CURRENT_STREAM, name


def test_wrappers_pass_each_c_parameter(recorded, monkeypatch):
    """Each wrapper passes as many arguments as its extern "C" launch
    function in csrc/ declares, and its library's ctypes argtypes list as
    many (ctypes would not notice a missing one)."""
    names = _launch_all(recorded)

    class Library:
        def __getattr__(self, name):
            fn = type(name, (), {})()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(kernels, "library", lambda name: Library())
    argtypes = {}
    for mod in (cuda_rnn, cuda_spectral, cuda_xcorr, cuda_analysis, cuda_frame):
        monkeypatch.setattr(mod, "_LIB", None)
        lib = mod._lib()
        argtypes.update({n: len(f.argtypes) for n, f in vars(lib).items()})
    src = "".join(open(f).read() for f in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")))
    for name in names:
        params = re.search(r"\bint " + name + r"\(([^)]*)\)", src).group(1)
        assert recorded.n_args[name] == argtypes[name] == params.count(",") + 1, name


def test_launch_makes_the_device_current(recorded):
    """kernels.launch enters the device, passes its stream, leaves the
    device again and raises on a non-zero error code."""
    dev = torch.device("cpu")
    seen = []

    def fn(*args):
        seen.append((list(recorded.entered), args[:-1], args[-1].value))
        return 0
    kernels.launch(fn, "probe", dev, 7)
    assert seen == [([dev], (7,), _stream_of(dev))]
    assert recorded.entered == []
    with pytest.raises(RuntimeError, match="probe"):
        kernels.launch(lambda *a: 2, "probe", dev)
