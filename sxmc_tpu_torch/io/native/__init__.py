"""ctypes binding of the native columnar event store (``evstore.cpp``,
the ``.sxnt`` format; port of ``sxmc_tpu/io/native/__init__.py``).

The library is built with ``g++`` at first use into
``<checkout>/build/evstore/<hash of the source>/`` (never next to the
source) and loaded with ctypes.  Where it cannot be built or loaded,
:func:`available` is False and every ``.sxnt`` read or write raises,
naming the reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "evstore.cpp"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lib_error: Optional[str] = None


def library_path() -> Path:
    """Where the built library lives: one directory per source and
    flags, under the checkout's ``build/``."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return (_SRC.parents[3] / "build" / "evstore" / h.hexdigest()[:16]
            / "libevstore.so")


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libevstore.{os.getpid()}.tmp.so")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, lib)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except Exception as e:  # no compiler, or the library does not load
        _lib_error = (e.stderr.decode() if isinstance(
            e, subprocess.CalledProcessError) and e.stderr else str(e))
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.sxnt_write.restype = ctypes.c_int
    lib.sxnt_write.argtypes = [ctypes.c_char_p, f32p, ctypes.c_uint64,
                               ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_char_p)]
    lib.sxnt_open.restype = ctypes.c_void_p
    lib.sxnt_open.argtypes = [ctypes.c_char_p]
    lib.sxnt_close.argtypes = [ctypes.c_void_p]
    lib.sxnt_nrows.restype = ctypes.c_uint64
    lib.sxnt_nrows.argtypes = [ctypes.c_void_p]
    lib.sxnt_nfields.restype = ctypes.c_uint32
    lib.sxnt_nfields.argtypes = [ctypes.c_void_p]
    lib.sxnt_field_name.restype = ctypes.c_int
    lib.sxnt_field_name.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_char_p, ctypes.c_uint32]
    lib.sxnt_read_all.restype = ctypes.c_int
    lib.sxnt_read_all.argtypes = [ctypes.c_void_p, f32p]
    lib.sxnt_select.restype = ctypes.c_int64
    lib.sxnt_select.argtypes = [ctypes.c_void_p, u32p, ctypes.c_uint32,
                                u32p, f32p, f32p, ctypes.c_uint32,
                                ctypes.c_float, f32p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native evstore unavailable: {_lib_error}")
    return lib


def write_sxnt(path: str, data: np.ndarray, fields: Sequence[str]) -> None:
    """Write a row-major float table as an SXNT file."""
    lib = _require()
    data = np.ascontiguousarray(data, np.float32)
    nrows, nfields = data.shape
    names = (ctypes.c_char_p * nfields)(*[f.encode() for f in fields])
    rc = lib.sxnt_write(
        str(path).encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nrows,
        nfields, names)
    if rc != 0:
        raise IOError(f"sxnt_write failed: {rc}")


class EventStore:
    """mmap-backed SXNT reader with native cuts and selection."""

    def __init__(self, path: str):
        lib = _require()
        self._lib = lib
        self._h = lib.sxnt_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open SXNT file: {path}")
        self.nrows = int(lib.sxnt_nrows(self._h))
        self.nfields = int(lib.sxnt_nfields(self._h))
        self.fields: List[str] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(self.nfields):
            lib.sxnt_field_name(self._h, i, buf, 256)
            self.fields.append(buf.value.decode())

    def close(self) -> None:
        if self._h:
            self._lib.sxnt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read_all(self) -> np.ndarray:
        out = np.empty((self.nrows, self.nfields), np.float32)
        rc = self._lib.sxnt_read_all(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"sxnt_read_all failed: {rc}")
        return out

    def select(self, sel_fields: Sequence[str],
               cuts: Sequence[Tuple[str, float, float]] = (),
               dataset_tag: float = 0.0) -> np.ndarray:
        """Native cuts, column mapping and the DATASET tag column: rows
        pass iff ``lo <= value <= hi`` for every cut (the native
        ``Signal.read_dataset_to_samples``, reference signal.cpp:
        50-109)."""
        sel_idx = np.asarray([self.fields.index(f) for f in sel_fields],
                             np.uint32)
        cut_idx = np.asarray([self.fields.index(c[0]) for c in cuts],
                             np.uint32)
        cut_lo = np.asarray([c[1] for c in cuts], np.float32)
        cut_hi = np.asarray([c[2] for c in cuts], np.float32)
        out = np.empty((self.nrows, len(sel_fields) + 1), np.float32)

        def ptr(a, ty):
            return (None if a.size == 0 else
                    a.ctypes.data_as(ctypes.POINTER(ty)))

        n = self._lib.sxnt_select(
            self._h, ptr(sel_idx, ctypes.c_uint32), len(sel_fields),
            ptr(cut_idx, ctypes.c_uint32), ptr(cut_lo, ctypes.c_float),
            ptr(cut_hi, ctypes.c_float), len(cuts),
            ctypes.c_float(dataset_tag),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise IOError(f"sxnt_select failed: {n}")
        return out[:n]
