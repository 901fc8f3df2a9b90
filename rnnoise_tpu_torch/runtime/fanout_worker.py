"""A worker process of ``fanout.FanoutPool``, run by path:

    python fanout_worker.py '<json config>'

It owns a native StreamPool for the global slots [slot_offset, slot_offset +
n_local) and serves its parent's bulk commands (attach, detach, push, pull,
assemble, commit, stop) against shared-memory tensors that the parent owns,
over a unix socket the parent passed by descriptor, in
``multiprocessing.connection``'s length-prefixed pickle.

It imports neither torch nor this package: only numpy, ctypes and the
standard library.  The stream-I/O library is one the parent built; the
worker loads it and ``streamio_abi.py`` (its signatures and pool methods)
by path, and reports ready once both are loaded.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import sys
from multiprocessing import shared_memory
from multiprocessing.connection import Connection

import numpy as np

FRAME = 480
ABI_PY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "streamio_abi.py")


def load_abi(path: str = ABI_PY):
    """``streamio_abi.py`` as a module of its own, outside the package."""
    spec = importlib.util.spec_from_file_location("_rnnt_streamio_abi", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach a segment WITHOUT taking ownership: the parent owns and
    unlinks it.  Python 3.12 registers an attached segment with this
    process's resource tracker, which would unlink it at exit; unregister."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:                                   # Python < 3.13
        shm = shared_memory.SharedMemory(name=name)
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
        return shm


def serve(cfg: dict) -> None:
    abi = load_abi()
    lib = abi.bind(ctypes.CDLL(cfg["lib"]))
    conn = Connection(cfg["fd"])
    n, off, total = cfg["n_local"], cfg["slot_offset"], cfg["total_slots"]
    t_max, io_cap = cfg["t_max"], cfg["io_cap"]
    pool = abi.Pool(lib, n, cfg["ring_frames"])
    shms = {k: attach_shm(v) for k, v in cfg["shm_names"].items()}
    try:
        in_batch = np.ndarray((t_max, total, FRAME), np.int16, shms["in"].buf)
        out_batch = np.ndarray((t_max, total, FRAME), np.int16, shms["out"].buf)
        counts = np.ndarray((total,), np.int32, shms["counts"].buf)[off:off + n]
        reset = np.ndarray((total,), np.uint8, shms["reset"].buf)[off:off + n]
        io = np.ndarray((total * io_cap,), np.int16, shms["io"].buf)
        conn.send(("ok", "ready"))
        while True:
            try:
                op, arg = conn.recv()
            except EOFError:                            # the parent is gone
                break
            if op == "stop":
                conn.send(("ok", None))
                break
            try:
                if op == "attach":
                    val = sum(pool.attach() >= 0 for _ in range(arg))
                elif op == "detach":
                    val = pool.detach(arg)
                elif op == "push":
                    val = pool.push_all_strided(
                        io[:total * arg].reshape(total, arg), off)
                elif op == "pull":
                    val = pool.pull_all_strided(
                        io[:total * arg].reshape(total, arg), off)
                elif op == "assemble":
                    val = pool.assemble_tm_i16_strided(arg, in_batch, off,
                                                       counts, reset)
                elif op == "commit":
                    val = pool.commit_tm_i16_strided(arg, out_batch, off,
                                                     counts)
                else:
                    raise ValueError(f"unknown op {op!r}")
            except Exception as e:  # noqa: BLE001 - report it, keep serving
                conn.send(("err", f"{type(e).__name__}: {e}"))
            else:
                conn.send(("ok", val))
    finally:
        # the numpy views above hold exports of the segments' buffers
        in_batch = out_batch = counts = reset = io = None
        for s in shms.values():
            s.close()
        pool.close()
        conn.close()


if __name__ == "__main__":
    serve(json.loads(sys.argv[1]))
