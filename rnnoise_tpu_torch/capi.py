"""Build the port's C ABI: the shim ``native/rnnoise_capi.cc`` of this
package as a shared library, and a C client linked against it.

The shim embeds the CPython interpreter that runs this function (its
headers, its ``libpython`` and its ``sys.executable``, as
``scripts/build_capi.sh`` does for the JAX package's shim) and imports
``rnnoise_tpu_torch.capi_glue``.  The library goes into a fresh directory
of its own under ``_build/`` (or ``out_dir``) and stays there while C
clients use it; the caller removes the directory.

    from rnnoise_tpu_torch import capi
    built = capi.build_capi()                 # .library, .directory
    demo = capi.build_demo(built)             # native/capi_demo.c
    # RNNOISE_TPU_DEVICE=cpu ./demo model.blob < in.pcm > out.pcm
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import uuid
from typing import NamedTuple, Optional

from . import kernels

SHIM = os.path.join(kernels.PKG_DIR, "native", "rnnoise_capi.cc")
REPO = os.path.dirname(kernels.PKG_DIR)
NATIVE_DIR = os.path.join(REPO, "native")
LIB_NAME = "rnnoise_tpu_torch_capi"


class CApiBuild(NamedTuple):
    directory: str
    library: str


def python_embedding() -> tuple[str, str, str]:
    """(include dir, library dir, LDVERSION) of this interpreter; raises
    RuntimeError when its headers or its shared libpython are missing."""
    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h in {include}: the C ABI cannot embed "
                           "this interpreter")
    if not libdir or not os.path.exists(os.path.join(libdir,
                                                     f"libpython{ver}.so")):
        raise RuntimeError(f"no libpython{ver}.so in {libdir}: the C ABI "
                           "cannot embed this interpreter")
    return include, libdir, ver


def _run(argv: list) -> None:
    res = subprocess.run(argv, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{argv[0]} failed:\n{res.stdout}{res.stderr}")


def build_capi(out_dir: Optional[str] = None) -> CApiBuild:
    """Compile the shim with g++ into ``out_dir`` (default: a fresh
    directory under ``_build/``)."""
    include, libdir, ver = python_embedding()
    if out_dir is None:
        out_dir = os.path.join(kernels.BUILD_DIR,
                               f"capi-{os.getpid()}-{uuid.uuid4().hex}")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{LIB_NAME}.so")
    _run(["g++", "-O2", "-shared", "-fPIC", "-o", lib, SHIM, f"-I{include}",
          f'-DRNNOISE_TPU_DEFAULT_PYTHON="{sys.executable}"',
          f'-DRNNOISE_TPU_DEFAULT_REPO="{REPO}"',
          f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"])
    return CApiBuild(out_dir, lib)


def build_demo(built: CApiBuild, source: str = os.path.join(
        NATIVE_DIR, "capi_demo.c")) -> str:
    """Compile a C client (default: the repo's unchanged
    ``native/capi_demo.c``) against the library; returns its path."""
    exe = os.path.join(built.directory, "capi_demo")
    _run(["gcc", "-O2", "-o", exe, source, f"-I{NATIVE_DIR}",
          f"-L{built.directory}", f"-Wl,-rpath,{built.directory}",
          f"-l{LIB_NAME}"])
    return exe
