"""ctypes binding for the native C++ sparse LU (native/sparse_lu.cc).

Mirrors the create/add/clear/factor/solve life-cycle of the reference's
matrix wrapper (pkg/matrix/circuit.go over edp1096/sparse).  The shared
library is built on demand with `make -C native` (g++); if no compiler is
available, `available()` returns False and callers fall back to the dense
NumPy path (a copy of the JAX package's ``native.py``; it loads the same
library from the repository's ``native/`` directory).
"""

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtsnative.so")

_lib = None
_load_error: Optional[str] = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tsn_create.restype = ctypes.c_void_p
        lib.tsn_create.argtypes = [ctypes.c_int]
        lib.tsn_destroy.argtypes = [ctypes.c_void_p]
        lib.tsn_clear.argtypes = [ctypes.c_void_p]
        lib.tsn_add.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double]
        lib.tsn_nnz.argtypes = [ctypes.c_void_p]
        lib.tsn_nnz.restype = ctypes.c_int
        lib.tsn_factor.argtypes = [ctypes.c_void_p]
        lib.tsn_factor.restype = ctypes.c_int
        lib.tsn_solve.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.tsn_solve.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain-dependent
        _load_error = str(e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


class SparseSolver:
    """Host-side sparse LU handle (0-based indices)."""

    def __init__(self, n: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self._lib = lib
        self._h = lib.tsn_create(n)
        self.n = n

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tsn_destroy(self._h)
            self._h = None

    def clear(self):
        self._lib.tsn_clear(self._h)

    def add(self, i: int, j: int, v: float):
        self._lib.tsn_add(self._h, i, j, v)

    def add_matrix(self, a: np.ndarray):
        rows, cols = np.nonzero(a)
        for i, j in zip(rows, cols):
            self._lib.tsn_add(self._h, int(i), int(j), float(a[i, j]))

    @property
    def nnz(self) -> int:
        return self._lib.tsn_nnz(self._h)

    def factor(self) -> bool:
        return self._lib.tsn_factor(self._h) == 0

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        rhs = np.ascontiguousarray(rhs, dtype=np.float64)
        out = np.empty(self.n, dtype=np.float64)
        if self._lib.tsn_solve(self._h, rhs, out) != 0:
            raise RuntimeError("solve failed (matrix singular or unfactored)")
        return out
