"""ctypes binding for the native async netCDF-classic writer (csrc/spnc).

Builds the shared library from csrc/spnc/spnc.cpp on first use with g++
(into csrc/build/, which git ignores). Falls back to a pure-Python
synchronous CDF-2 writer with the same interface if the toolchain is
unavailable, so the IO layer never hard-depends on the native build.
"""

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

from . import nc3

log = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "spnc", "spnc.cpp")
_BUILD = os.path.join(_ROOT, "csrc", "build")
_LIB = os.path.join(_BUILD, "libspnc.so")

_lib = None
_lib_tried = False


def _load_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(_BUILD, exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-pthread", _SRC, "-o", _LIB],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB)
        lib.spnc_create.restype = ctypes.c_void_p
        lib.spnc_create.argtypes = [ctypes.c_char_p]
        lib.spnc_def_dim.restype = ctypes.c_int32
        lib.spnc_def_dim.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint32]
        lib.spnc_def_var.restype = ctypes.c_int32
        lib.spnc_def_var.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.spnc_enddef.argtypes = [ctypes.c_void_p]
        lib.spnc_put.restype = ctypes.c_int32
        lib.spnc_put.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_uint64]
        lib.spnc_queue_depth.restype = ctypes.c_int64
        lib.spnc_queue_depth.argtypes = [ctypes.c_void_p]
        lib.spnc_flush.argtypes = [ctypes.c_void_p]
        lib.spnc_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        log.info("native spnc writer loaded (%s)", _LIB)
    except Exception as e:
        log.warning("native spnc unavailable (%s); using Python fallback", e)
        _lib = None
    return _lib


class NativeCDFWriter:
    """Async netCDF-classic writer backed by the C++ worker thread."""

    def __init__(self, path):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native spnc not available")
        self._lib = lib
        self._h = lib.spnc_create(path.encode())
        if not self._h:
            raise OSError("spnc_create failed for " + path)
        self._open = True

    def def_dim(self, name, length):
        """length None/0 -> the record (unlimited) dimension."""
        return self._lib.spnc_def_dim(self._h, name.encode(),
                                      0 if not length else int(length))

    def def_var(self, name, units, dimids):
        arr = (ctypes.c_int32 * len(dimids))(*dimids)
        return self._lib.spnc_def_var(self._h, name.encode(),
                                      units.encode(), len(dimids), arr)

    def enddef(self):
        self._lib.spnc_enddef(self._h)

    def put(self, vid, rec, data):
        data = np.ascontiguousarray(data, np.float32)
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.spnc_put(self._h, vid, rec, ptr, data.size)

    def queue_depth(self):
        return int(self._lib.spnc_queue_depth(self._h))

    def flush(self):
        self._lib.spnc_flush(self._h)

    def close(self):
        if self._open:
            self._lib.spnc_close(self._h)
            self._open = False


class PythonCDFWriter:
    """Synchronous pure-Python writer with the same interface (io/nc3.py)."""

    def __init__(self, path):
        self._ds = nc3.Dataset(path, "w")
        self._vars = []
        self._lock = threading.Lock()

    def def_dim(self, name, length):
        """length None/0 -> the record (unlimited) dimension."""
        self._ds.createDimension(name, length or None)
        return len(self._ds.dimensions) - 1

    def def_var(self, name, units, dimids):
        dims = list(self._ds.dimensions)
        self._ds.createVariable(name, "f4", [dims[d] for d in dimids],
                                **({"units": units} if units else {}))
        self._vars.append(name)
        return len(self._vars) - 1

    def enddef(self):
        self._ds.enddef()

    def put(self, vid, rec, data):
        with self._lock:
            self._ds.put(self._vars[vid], data, rec)

    def queue_depth(self):
        return 0

    def flush(self):
        with self._lock:
            self._ds.sync()

    def close(self):
        with self._lock:
            self._ds.close()


def create_writer(path):
    """Native async writer when available, Python fallback otherwise."""
    if _load_lib() is not None:
        try:
            return NativeCDFWriter(path)
        except Exception as e:
            log.warning("native writer failed (%s); Python fallback", e)
    return PythonCDFWriter(path)


def read_cdf(path):
    """CDF-1/2 file -> ({var: array}, {var: units}) (via io/nc3.py)."""
    with nc3.Dataset(path, "r") as ds:
        return ({n: v[...] for n, v in ds.variables.items()},
                {n: v.units for n, v in ds.variables.items()})
