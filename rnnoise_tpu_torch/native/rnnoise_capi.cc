// C ABI shim: the reference's public C interface (include/rnnoise.h:57-125)
// backed by rnnoise_tpu_torch (the PyTorch/CUDA port) through an embedded
// CPython interpreter.  A copy of the JAX package's native/rnnoise_capi.cc
// that imports rnnoise_tpu_torch.capi_glue; it implements the same
// native/rnnoise_tpu.h, so native/capi_demo.c links against either library.
//
// Role: lets existing C/C++ applications that link librnnoise swap in this
// framework without source changes — rnnoise_create/process_frame/destroy and
// the three model loaders behave per the reference contract (10 ms frames,
// VAD return, NULL model = default).  One DenoiseState wraps one stream of a
// StreamDenoiser, on the GPU unless RNNOISE_TPU_DEVICE names another device;
// the scale path (thousands of streams per card) remains the batched engine
// (rnnoise_tpu_torch.runtime.engine) — this shim is the compatibility
// surface, matching the single-stream semantics of the reference API.
//
// Build: rnnoise_tpu_torch.capi.build_capi()  ->  librnnoise_tpu_torch_capi.so
// Every entry point grabs the GIL (PyGILState), so multi-threaded callers
// with one state per thread work like they do against the C library.

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

extern "C" {

typedef struct DenoiseState DenoiseState;
typedef struct RNNModel RNNModel;

struct RNNModel {
  PyObject *blob;   // bytes (model blob content)
};

struct DenoiseState {
  PyObject *denoiser;  // rnnoise_tpu_torch.capi_glue.CStream
};

#define RNNOISE_FRAME_SIZE 480

static PyObject *g_glue = nullptr;  // module rnnoise_tpu_torch.capi_glue
static std::once_flag g_init_once;

static void init_python() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      PyConfig config;
      PyConfig_InitPythonConfig(&config);
      // Resolve the venv/site layout the host application may not know
      // about: RNNOISE_TPU_PYTHON overrides, else the build-time default.
      const char *prog = getenv("RNNOISE_TPU_PYTHON");
#ifdef RNNOISE_TPU_DEFAULT_PYTHON
      if (!prog) prog = RNNOISE_TPU_DEFAULT_PYTHON;
#endif
      if (prog) PyConfig_SetBytesString(&config, &config.program_name, prog);
      Py_InitializeFromConfig(&config);
      PyConfig_Clear(&config);
      // Release the GIL acquired by initialization so PyGILState_Ensure
      // works from any thread (including this one) afterwards.
      PyEval_SaveThread();
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    const char *repo = getenv("RNNOISE_TPU_REPO");
#ifdef RNNOISE_TPU_DEFAULT_REPO
    if (!repo) repo = RNNOISE_TPU_DEFAULT_REPO;
#endif
    if (repo && sys_path) {
      PyObject *p = PyUnicode_FromString(repo);
      PyList_Insert(sys_path, 0, p);
      Py_DECREF(p);
    }
    g_glue = PyImport_ImportModule("rnnoise_tpu_torch.capi_glue");
    if (!g_glue) PyErr_Print();
    PyGILState_Release(gil);
  });
}

int rnnoise_get_frame_size(void) { return RNNOISE_FRAME_SIZE; }

// The reference exposes its state size so callers can manage the memory
// themselves (rnnoise.h:57).  Here the state is an opaque handle around a
// Python object; the handle size is what a caller placement-allocates.
int rnnoise_get_size(void) { return (int)sizeof(DenoiseState); }

// Like the reference (denoise.c:285, which memsets the caller's buffer),
// rnnoise_init treats *st as possibly-uninitialized memory — callers using
// rnnoise_get_size + their own allocation need not zero it first.  The cost
// of matching that contract: re-initialising a LIVE state leaks its old
// Python object (we cannot distinguish a stale pointer from garbage).  Use
// rnnoise_destroy + rnnoise_create to re-init without the leak.
int rnnoise_init(DenoiseState *st, RNNModel *model) {
  init_python();
  if (!g_glue) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  st->denoiser = PyObject_CallMethod(
      g_glue, "create", "O", model ? model->blob : Py_None);
  if (!st->denoiser) PyErr_Print();
  PyGILState_Release(gil);
  return st->denoiser ? 0 : -1;
}

DenoiseState *rnnoise_create(RNNModel *model) {
  DenoiseState *st = (DenoiseState *)calloc(1, sizeof(DenoiseState));
  if (!st) return nullptr;
  if (rnnoise_init(st, model) != 0) {
    free(st);
    return nullptr;
  }
  return st;
}

void rnnoise_destroy(DenoiseState *st) {
  if (!st) return;
  if (st->denoiser) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_DECREF(st->denoiser);
    PyGILState_Release(gil);
  }
  free(st);
}

float rnnoise_process_frame(DenoiseState *st, float *out, const float *in) {
  if (!st || !st->denoiser) return 0.0f;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *in_mv = PyMemoryView_FromMemory(
      (char *)in, RNNOISE_FRAME_SIZE * sizeof(float), PyBUF_READ);
  PyObject *out_mv = PyMemoryView_FromMemory(
      (char *)out, RNNOISE_FRAME_SIZE * sizeof(float), PyBUF_WRITE);
  PyObject *res = PyObject_CallMethod(g_glue, "process", "OOO",
                                      st->denoiser, in_mv, out_mv);
  float vad = 0.0f;
  if (res) {
    vad = (float)PyFloat_AsDouble(res);
    Py_DECREF(res);
  } else {
    PyErr_Print();
  }
  Py_XDECREF(in_mv);
  Py_XDECREF(out_mv);
  PyGILState_Release(gil);
  return vad;
}

RNNModel *rnnoise_model_from_buffer(const void *ptr, int len) {
  init_python();
  if (!g_glue || !ptr || len <= 0) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  RNNModel *m = (RNNModel *)calloc(1, sizeof(RNNModel));
  m->blob = PyBytes_FromStringAndSize((const char *)ptr, len);
  PyGILState_Release(gil);
  if (!m->blob) {
    free(m);
    return nullptr;
  }
  return m;
}

RNNModel *rnnoise_model_from_file(FILE *f) {
  if (!f) return nullptr;
  long pos = ftell(f);
  if (fseek(f, 0, SEEK_END) != 0) return nullptr;
  long end = ftell(f);
  fseek(f, pos < 0 ? 0 : pos, SEEK_SET);
  long len = end - (pos < 0 ? 0 : pos);
  if (len <= 0) return nullptr;
  char *buf = (char *)malloc((size_t)len);
  if (!buf) return nullptr;
  size_t got = fread(buf, 1, (size_t)len, f);
  RNNModel *m = got == (size_t)len
                    ? rnnoise_model_from_buffer(buf, (int)len)
                    : nullptr;
  free(buf);  // from_buffer copied into a bytes object
  return m;
}

RNNModel *rnnoise_model_from_filename(const char *filename) {
  FILE *f = fopen(filename, "rb");
  if (!f) return nullptr;
  RNNModel *m = rnnoise_model_from_file(f);
  fclose(f);
  return m;
}

void rnnoise_model_free(RNNModel *model) {
  if (!model) return;
  if (model->blob) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_DECREF(model->blob);
    PyGILState_Release(gil);
  }
  free(model);
}

}  // extern "C"
