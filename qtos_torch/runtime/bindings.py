"""ctypes bindings to the native host runtime (`native/qtos_native.cpp`: grid
A* and the trajectory ring buffer), built once with the host C++ compiler.

The library is compiled at first use into `qtos_torch/_build/` under the
cache name of `qtos_torch.ops.cuda_lib` (keyed by the source's hash), never
next to the source.  Every entry point has a pure python fallback so the
package works without a C++ toolchain; `native_available()` says which one
is in use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from qtos_torch.ops import cuda_lib

SOURCE = os.path.join(cuda_lib.PKG_DIR, "runtime", "native", "qtos_native.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the built library lives (whether or not it is built yet)."""
    return cuda_lib.cache_path(SOURCE, "libqtos_native")


def _build(out: str) -> bool:
    cxx = cuda_lib.host_cxx()
    if cxx is None:
        return False
    try:
        cuda_lib.compile_to(out, lambda tmp: [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp],
                            timeout=120)
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        p_float = ctypes.POINTER(ctypes.c_float)
        lib.qtos_astar.restype = c_int
        lib.qtos_astar.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), c_int, c_int, c_int, c_int, c_int, c_int,
            c_int, ctypes.POINTER(c_int), c_int,
        ]
        lib.qtos_ringbuf_create.restype = c_void_p
        lib.qtos_ringbuf_create.argtypes = [c_int, c_int]
        lib.qtos_ringbuf_free.restype = None
        lib.qtos_ringbuf_free.argtypes = [c_void_p]
        lib.qtos_ringbuf_end.restype = c_int
        lib.qtos_ringbuf_end.argtypes = [c_void_p]
        lib.qtos_ringbuf_stitch.restype = c_int
        lib.qtos_ringbuf_stitch.argtypes = [c_void_p, c_int, p_float, p_float, c_int]
        lib.qtos_ringbuf_read.restype = c_int
        lib.qtos_ringbuf_read.argtypes = [c_void_p, c_int, c_int, p_float]
        lib.qtos_ringbuf_find_contact.restype = c_int
        lib.qtos_ringbuf_find_contact.argtypes = [c_void_p, c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_astar(blocked: np.ndarray, start, goal, diagonal: bool = True):
    """Native A*; returns (N, 2) int32 path or None (unreachable / no lib)."""
    lib = _load()
    if lib is None:
        return None
    blocked = np.ascontiguousarray(np.asarray(blocked) > 0.5, dtype=np.uint8)
    H, W = blocked.shape
    max_len = H * W + 4
    out = np.zeros((max_len, 2), np.int32)
    n = lib.qtos_astar(
        blocked.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        H, W, int(start[0]), int(start[1]), int(goal[0]), int(goal[1]),
        int(diagonal),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_len,
    )
    if n < 0:
        return None
    return out[:n].copy()


class RingBuffer:
    """Host-side trajectory ring buffer (native when available).

    Replaces the reference's CSV-file data plane: `stitch(at, rows, contact)`
    is combiner.combine's truncate-and-concat (QTOS/combiner.py:125-135),
    `find_contact_row` the stitch-point scan (:245-296), `read` the sim
    loop's row reader (scripts/run.py:184).

    `native=False` forces the numpy implementation (the tests hold the two
    to each other); the default takes the native one when it built."""

    COLS = 37

    def __init__(self, capacity: int = 60000, native: bool | None = None):
        self.capacity = capacity
        self._lib = _load() if native is None or native else None
        if native and self._lib is None:
            raise RuntimeError("RingBuffer(native=True): the native library is not available")
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.qtos_ringbuf_create(capacity, self.COLS))
        else:
            self._traj = np.zeros((capacity, self.COLS), np.float32)
            self._contact = np.zeros((capacity, 4), np.float32)
            self._end = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.qtos_ringbuf_free(self._h)
            self._h = None

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    @property
    def end(self) -> int:
        if self._lib is not None:
            return self._lib.qtos_ringbuf_end(self._h)
        return self._end

    def stitch(self, at: int, rows: np.ndarray, contact: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, np.float32)
        contact = np.ascontiguousarray(contact, np.float32)
        n = rows.shape[0]
        if rows.shape != (n, self.COLS) or contact.shape != (n, 4):
            raise ValueError(f"stitch takes (n, {self.COLS}) rows and (n, 4) contacts, "
                             f"got {rows.shape} and {contact.shape}")
        if self._lib is not None:
            r = self._lib.qtos_ringbuf_stitch(
                self._h, at,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                contact.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            )
            if r < 0:
                raise ValueError(f"stitch out of range: at={at} n={n} cap={self.capacity}")
            return r
        if at < 0 or at > self._end or at + n > self.capacity:
            raise ValueError(f"stitch out of range: at={at} n={n} cap={self.capacity}")
        self._traj[at : at + n] = rows
        self._contact[at : at + n] = contact
        self._end = at + n
        return self._end

    def read(self, start: int, n: int) -> np.ndarray:
        """Rows [start, start + n), cut at the end; none when `start` lies
        outside the valid rows."""
        if n <= 0 or start < 0 or start >= self.end:
            return np.zeros((0, self.COLS), np.float32)
        if self._lib is not None:
            out = np.zeros((n, self.COLS), np.float32)
            got = self._lib.qtos_ringbuf_read(
                self._h, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            return out[:got]
        stop = min(start + n, self._end)
        return self._traj[start:stop].copy()

    def find_contact_row(self, from_row: int) -> int:
        if self._lib is not None:
            return self._lib.qtos_ringbuf_find_contact(self._h, from_row)
        from_row = max(from_row, 0)
        sub = self._contact[from_row : self._end]
        hits = np.nonzero(sub.min(axis=1) > 0.5)[0]
        return int(from_row + hits[0]) if len(hits) else -1
