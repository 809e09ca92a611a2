"""The host C++ replay gather (``csrc/replay_gather.cpp``), built with ``g++``
at first use and bound with ``ctypes`` (the port's own copy of the loader in
``sheeprl_tpu/native/__init__.py``).

The shared object goes to ``csrc/build/`` under a name keyed by the source's
hash, so an edited source is rebuilt. Where it cannot be built or loaded
(no compiler, a read-only checkout) the buffers keep their numpy gather, as
the JAX package does for this host code, and one line on stderr names the
reason; ``status()`` reports it too.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "replay_gather.cpp"
_BUILD = _SRC.parent / "build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None
_SO: Optional[Path] = None
N_THREADS = 4  # copy threads of one gather of at least 1 MiB


def _build(so_path: Path) -> Optional[str]:
    """Compile ``so_path``; returns why it failed, or None."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(".tmp.so")
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr.strip()[-300:]}"
    tmp.replace(so_path)
    return None


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None where it is unavailable."""
    global _LIB, _TRIED, _REASON, _SO
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so_path = _BUILD / f"replay_gather_{digest}.so"
        try:
            if not so_path.is_file():
                _REASON = _build(so_path)
            if _REASON is None:
                lib = ctypes.CDLL(str(so_path))
                lib.gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_int32]
                lib.gather_rows.restype = None
                _LIB, _SO = lib, so_path
        except (OSError, subprocess.SubprocessError) as err:
            _REASON = f"{type(err).__name__}: {err}"
        if _LIB is None:
            print(f"[native] the replay gather is not built ({_REASON}); the numpy gather runs instead",
                  file=sys.stderr, flush=True)
        return _LIB


def status() -> Dict[str, Any]:
    """Whether the native gather is loaded, from where, or why not."""
    load_native()
    return {"loaded": _LIB is not None, "library": None if _SO is None else str(_SO), "reason": _REASON}


def gather_rows(src: np.ndarray, row_idx: np.ndarray, out_shape) -> Optional[np.ndarray]:
    """Gather rows of a C-contiguous array by flat leading-axis index:
    ``src`` is [R, ...], ``row_idx`` (any shape, int64) selects rows in
    destination order. Returns the rows reshaped to ``out_shape``, or None
    where the native path cannot take the input (the caller gathers with
    numpy)."""
    lib = load_native()
    if lib is None:
        return None
    src = np.asarray(src)
    if not src.flags["C_CONTIGUOUS"] or src.dtype.hasobject:
        return None
    idx = np.ascontiguousarray(row_idx, dtype=np.int64)
    n_out = idx.size
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if row_bytes == 0:
        return np.empty(out_shape, dtype=src.dtype)
    out = np.empty((n_out,) + src.shape[1:], dtype=src.dtype)
    lib.gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(row_bytes),
        idx.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_out),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(N_THREADS),
    )
    return out.reshape(out_shape)
