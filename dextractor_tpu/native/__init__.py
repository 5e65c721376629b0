"""Native host-side helpers, built on demand with the system toolchain.

Shims are compiled once into ``native/build/`` and loaded via ctypes; every
consumer must degrade gracefully (feature-gated) when a shim cannot build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")


def _build_shim(name: str, extra: list[str] | None = None):
    src = os.path.join(_DIR, f"{name}.c")
    out = os.path.join(_BUILD, f"_{name}.so")
    os.makedirs(_BUILD, exist_ok=True)
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        # compile to a private temp then os.replace: concurrent builders
        # (parallel pytest workers) must never dlopen a half-written .so
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["gcc", "-O2", "-shared", "-fPIC", src, "-o", tmp, "-ldl"]
        if extra:
            cmd[5:5] = extra
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise OSError(f"building {name} failed: {r.stderr[:500]}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)


_qv = None
_qv_err = None


def qv_decode_shim():
    """The sequential .dexqv walker, or raise OSError if unavailable."""
    global _qv, _qv_err
    if _qv is not None:
        return _qv
    if _qv_err is not None:
        raise _qv_err
    try:
        import numpy as np

        lib = _build_shim("qv_decode")
        lib.dxt_qv_walk.restype = ctypes.c_longlong
        lib.dxt_qv_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.dxt_quiva_text.restype = ctypes.c_longlong
        lib.dxt_quiva_text.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    except OSError as e:
        _qv_err = e
        raise
    _qv = lib
    return lib


_qve = None
_qve_err = None


def qv_encode_shim():
    """The host-side channel encoder, or raise OSError if unavailable."""
    global _qve, _qve_err
    if _qve is not None:
        return _qve
    if _qve_err is not None:
        raise _qve_err
    try:
        lib = _build_shim("qv_encode")
        for fn, extra in (("dxt_encode_plain", 0), ("dxt_encode_run", 1),
                          ("dxt_pack_tags", 2)):
            f = getattr(lib, fn)
            f.restype = ctypes.c_longlong
        lib.dxt_encode_plain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.dxt_encode_run.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.dxt_pack_tags.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.dxt_ragged_copy.restype = None
        lib.dxt_ragged_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong]
        lib.dxt_run_hist.restype = None
        lib.dxt_run_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        lib.dxt_gather_copy.restype = None
        lib.dxt_gather_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong]
        lib.dxt_qv_scan_hists.restype = None
        lib.dxt_qv_scan_hists.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
    except OSError as e:
        _qve_err = e
        raise
    _qve = lib
    return lib


_dexta = None
_dexta_err = None


_tbh = None
_tbh_err = None


def twobit_host_shim():
    """Host 2-bit pack / wrapped-text unpack, or raise OSError."""
    global _tbh, _tbh_err
    if _tbh is not None:
        return _tbh
    if _tbh_err is not None:
        raise _tbh_err
    try:
        lib = _build_shim("twobit_host")
        lib.dxt_pack_seq.restype = ctypes.c_longlong
        lib.dxt_pack_seq.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.dxt_unpack_text.restype = ctypes.c_longlong
        lib.dxt_unpack_text.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.dxt_line_stats.restype = None
        lib.dxt_line_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.dxt_seq_scan.restype = ctypes.c_longlong
        lib.dxt_seq_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
    except OSError as e:
        _tbh_err = e
        raise
    _tbh = lib
    return lib


def dexta_index_shim():
    """The .dexta/.dexar entry walker, or raise OSError if unavailable."""
    global _dexta, _dexta_err
    if _dexta is not None:
        return _dexta
    if _dexta_err is not None:
        raise _dexta_err
    try:
        lib = _build_shim("dexta_index")
        lib.dxt_dexta_walk.restype = ctypes.c_longlong
        lib.dxt_dexta_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    except OSError as e:
        _dexta_err = e
        raise
    _dexta = lib
    return lib


_hdf5 = None
_hdf5_err = None


def hdf5_shim():
    """The HDF5 dlopen shim, or raise OSError if unavailable."""
    global _hdf5, _hdf5_err
    if _hdf5 is not None:
        return _hdf5
    if _hdf5_err is not None:
        raise _hdf5_err
    try:
        lib = _build_shim("hdf5_shim")
        lib.dxt_h5_init.argtypes = [ctypes.c_char_p]
        lib.dxt_h5_init.restype = ctypes.c_int
        lib.dxt_h5_open.argtypes = [ctypes.c_char_p]
        lib.dxt_h5_open.restype = ctypes.c_longlong
        lib.dxt_h5_close.argtypes = [ctypes.c_longlong]
        lib.dxt_h5_dataset_dims.argtypes = [
            ctypes.c_longlong, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.dxt_h5_dataset_dims.restype = ctypes.c_int
        lib.dxt_h5_read.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.dxt_h5_read.restype = ctypes.c_int
        lib.dxt_h5_attr_str.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.dxt_h5_attr_str.restype = ctypes.c_int
        lib.dxt_h5_create.argtypes = [ctypes.c_char_p]
        lib.dxt_h5_create.restype = ctypes.c_longlong
        lib.dxt_h5_write.argtypes = [
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.dxt_h5_write.restype = ctypes.c_int
        lib.dxt_h5_attr_str_write.argtypes = [
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.dxt_h5_attr_str_write.restype = ctypes.c_int
        if lib.dxt_h5_init(b"") != 0:
            raise OSError("libhdf5 could not be initialized")
    except OSError as e:
        _hdf5_err = e
        raise
    _hdf5 = lib
    return lib
