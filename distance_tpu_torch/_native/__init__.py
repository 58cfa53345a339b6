"""Build-on-demand ctypes loader for the native host runtime.

Compiles native.c into a shared library on first use (cached next to the
source).  If no C toolchain is available the callers fall back to pure
Python paths — the native library is a performance component, not a
correctness requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.c")
_SO = os.path.join(_HERE, "libdistance_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cc = os.environ.get("CC", "cc")
    # Link to a temp path, then atomically rename over the cached .so:
    # a process that already dlopened the old library keeps its mapping
    # (same-path relink would truncate the mapped inode under it).
    tmp = _SO + f".build.{os.getpid()}"
    # -ffp-contract=off: Rust never contracts mul+add into FMA; allowing
    # contraction changes f64 results (e.g. jc69 at p=0.75) and breaks
    # bit-for-bit parity.
    cmd = [
        cc, "-O3", "-march=native", "-ffp-contract=off",
        "-shared", "-fPIC", _SRC, "-o", tmp, "-lm",
    ]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            # retry without -march=native for odd toolchains
            try:
                cmd.remove("-march=native")
                subprocess.run(cmd, check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError, ValueError):
                return False
        os.replace(tmp, _SO)
        return True
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    p_d = ctypes.POINTER(ctypes.c_double)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_c = ctypes.c_char_p

    lib.dt_finalize_raw.argtypes = [p_i32, p_i32, p_d, i64]
    lib.dt_finalize_jc69.argtypes = [p_i32, p_i32, p_d, i64]
    lib.dt_finalize_k80.argtypes = [p_i32, p_i32, p_i32, p_d, i64]
    lib.dt_finalize_tn93_gather.argtypes = [
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_d, i64,
    ]
    lib.dt_format_rows_f64.argtypes = [
        p_c, p_i64, p_c, p_i64, p_i32, p_i32, p_d, i64,
        ctypes.c_char_p, i64,
    ]
    lib.dt_format_rows_f64.restype = i64
    lib.dt_format_rows_i64.argtypes = [
        p_c, p_i64, p_c, p_i64, p_i32, p_i32, p_i64, i64,
        ctypes.c_char_p, i64,
    ]
    lib.dt_format_rows_i64.restype = i64
    lib.dt_format_rows_pre.argtypes = [
        p_c, p_i64, p_c, p_i64, p_i32, p_i32,
        p_c, p_i64, p_i32, i64, ctypes.c_void_p, i64,
    ]
    lib.dt_format_rows_pre.restype = i64
    lib.dt_key_rank.argtypes = [p_i32, i64, p_i32, p_i32, p_i64, p_i32]
    lib.dt_key_rank.restype = i64
    lib.dt_row_bounds.argtypes = [
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, i64, p_i64,
    ]
    lib.dt_row_bounds.restype = None
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i16 = ctypes.POINTER(ctypes.c_int16)
    lib.dt_code_hist.argtypes = [p_u8, i64, i64, p_i16, p_u8, p_i32, i64]
    lib.dt_cpu_raw_pairs.argtypes = [p_u8, i64, i64, p_i32, p_i32, i64]
    lib.dt_cpu_raw_pairs.restype = i64
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    lib.dt_transpose_add_i32.argtypes = [
        p_i32, i64, i64, i64, i64, p_i32, p_i32,
    ]
    lib.dt_transpose_add_i32.restype = None
    lib.dt_rel4_expand_add.argtypes = [
        p_i8, i64, i64, i64, p_i32, p_i32, ctypes.c_int32, i64, p_i32,
    ]
    lib.dt_rel4_expand_add.restype = i64
    lib.dt_diff_count.argtypes = [p_u8, p_u8, i64, i64]
    lib.dt_diff_count.restype = i64
    lib.dt_diff_fill.argtypes = [p_u8, p_u8, i64, i64, i64, p_i32, p_u8]
    lib.dt_diff_fill.restype = i64
    lib.dt_parse_fasta_fill.argtypes = [
        p_u8, i64, i64, i64, p_u8,          # data, len, width, max_recs, enc
        p_u8, ctypes.c_void_p, i64, p_i64,  # matrix, ids, ids_cap, id_offs
        ctypes.c_void_p, i64, p_i64,        # descs, descs_cap, desc_offs
        p_i64, p_i64, p_i64, p_i64,         # n_out, err_a, err_b, tallies
    ]
    lib.dt_parse_fasta_fill.restype = ctypes.c_int
    lib.dt_gather_strip_tri.argtypes = [
        p_i32, i64, i64, i64, i64, i64, i64, p_i64, i64, i64, i64,
        p_i32, p_i32, p_i32, i64,
    ]
    lib.dt_gather_strip_tri.restype = None
    lib.dt_keys_lin3.argtypes = [
        p_i32, p_i32, p_i32, i64, i64, i64, i64, i64, p_i32,
    ]
    lib.dt_keys_lin3.restype = None
    lib.dt_minmax_i32.argtypes = [p_i32, i64, i64, p_i32, p_i32]
    lib.dt_minmax_i32.restype = None
    lib.dt_keys_rank2.argtypes = [
        p_i32, p_i32, p_i32, p_i32, p_i32, i64, i64, i64, p_i32,
    ]
    lib.dt_keys_rank2.restype = None
    lib.dt_keys_hashrank_slots.argtypes = [
        p_i32, p_i32, p_i32, p_i32, p_i32, i64, i64, i64, i64,
        p_i64, i64, i64, p_i64, p_i32,
    ]
    lib.dt_keys_hashrank_slots.restype = ctypes.c_int
    lib.dt_map_i32.argtypes = [p_i32, i64, i64, p_i32]
    lib.dt_map_i32.restype = None
    lib.dt_count_bases.argtypes = [p_u8, i64, i64, p_u8, p_i32]
    lib.dt_count_bases.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DISTANCE_TPU_NO_NATIVE"):
            return None
        needs_build = (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        )
        if needs_build and not _build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(_SO))
        except OSError:
            _lib = None
    return _lib
