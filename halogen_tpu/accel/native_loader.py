"""ctypes loader for the native (C++) acceleration-structure builder.

The native tier of the host runtime: on first use, compiles
`accel/native/bvh_builder.cpp` from the checkout (g++ -O3 -shared) into
`accel/native/_bvh_builder.so`, which git ignores, and exposes
`build_bvh_sah`, a binned-SAH builder producing the same flat node layout
as the Python builder (`accel/bvh.py`) — drop-in, higher quality (SAH was
the reference's own TODO, `HalgoenCompute.compute:16`), and fast enough for
dragon-class meshes. The library is rebuilt whenever it is older than the
source. If the build fails, a warning is logged and callers fall back to
the numpy builder (`available()` is False).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "bvh_builder.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "native", "_bvh_builder.so")
_lock = threading.Lock()
_lib = None
_load_failed = False


def _compile() -> bool:
    # Build under a per-process name and rename into place, so processes
    # that import the package at once never load a half-written library.
    # No -march=native: the checkout may be copied to another machine.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except subprocess.CalledProcessError as e:
        detail = e.stderr.decode(errors="replace").strip()
    except (subprocess.SubprocessError, OSError) as e:
        detail = str(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    logging.getLogger("halogen_tpu").warning(
        "native BVH builder did not build (%s); using the numpy builder",
        detail)
    return False


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            if not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            fn = lib.halogen_build_bvh_sah
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except OSError as e:
            logging.getLogger("halogen_tpu").warning(
                "native BVH builder did not load (%s); using the numpy "
                "builder", e)
            _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_sah(tri_verts: np.ndarray, max_leaf: int, max_depth: int):
    """Binned-SAH build. Returns (lo, hi, index_a, count, tri_order, depth)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tri_verts, np.float32)
    n = tris.shape[0]
    cap = max(2 * n, 1)
    lo = np.zeros((cap, 3), np.float32)
    hi = np.zeros((cap, 3), np.float32)
    index_a = np.zeros((cap,), np.int32)
    count = np.zeros((cap,), np.int32)
    order = np.zeros((max(n, 1),), np.int32)
    depth = ctypes.c_int32(0)
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    num = lib.halogen_build_bvh_sah(
        f32p(tris), n, max_leaf, max_depth,
        f32p(lo), f32p(hi), i32p(index_a), i32p(count), i32p(order), cap,
        ctypes.byref(depth),
    )
    if num < 0:
        return None
    return (lo[:num].copy(), hi[:num].copy(), index_a[:num].copy(),
            count[:num].copy(), order, int(depth.value))
