"""ctypes bridge to the repository's native CSV-matrix reader
(``native/csv_matrix.cpp``, built into ``native/libcsv_matrix.so`` by
``make -C native``) — counterpart of ``dstagnn_drought_tpu/data/native.py``.

A host parser outside both packages; where the library is not there (or
does not load), ``load_dense_csv`` falls back to numpy, as in JAX.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libcsv_matrix.so",
)


class _Library:
    """The library, loaded on first use (``None`` when absent)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = None
        self._checked = False

    def get(self):
        if not self._checked:
            self._checked = True
            if os.path.exists(self.path):
                try:
                    lib = ctypes.CDLL(self.path)
                except OSError:
                    return None
                lib.csv_matrix_read_alloc.restype = ctypes.c_longlong
                lib.csv_matrix_read_alloc.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_longlong),
                ]
                lib.csv_matrix_free.restype = None
                lib.csv_matrix_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
                self._lib = lib
        return self._lib


_library = _Library(LIB_PATH)


def native_available() -> bool:
    return _library.get() is not None


def load_dense_csv(path: str) -> np.ndarray:
    """Headerless dense CSV → (rows, cols) float64; the native parser when
    the library is there, else numpy. ``IOError`` for a file the parser
    refuses (ragged rows)."""
    if not os.path.exists(path):
        # the native parser's -1 is opaque; surface the common case clearly
        raise FileNotFoundError(path)
    lib = _library.get()
    if lib is None:
        return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    ptr = ctypes.POINTER(ctypes.c_double)()
    n = lib.csv_matrix_read_alloc(
        path.encode(), ctypes.byref(ptr), ctypes.byref(rows), ctypes.byref(cols)
    )
    if n < 0:
        raise IOError(f"csv_matrix_read_alloc failed ({n}) for {path}")
    try:
        r, c = rows.value, cols.value
        if r * c != n:
            raise IOError(f"ragged CSV {path}: {r}x{c} != {n}")
        out = np.ctypeslib.as_array(ptr, shape=(r, c)).copy()
    finally:
        lib.csv_matrix_free(ptr)
    return out
