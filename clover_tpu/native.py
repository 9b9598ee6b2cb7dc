"""ctypes bindings for the native host runtime (native/clover_host.cpp).

The device compute path is JAX/Pallas; this is the native CPU side — a
fast quantizer / data-loader producing bit-compatible packed containers
(so hosts can stage quantized datasets for the device at 1/8 the
transfer size) and an independent C++ implementation of the golden
semantics for cross-validation.

Lazily loads ``native/libclover_host.so``; builds it with ``make`` on
first use if a toolchain is present.  ``available()`` gates everything —
all functionality has pure-Python equivalents.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE_DIR, "libclover_host.so")

i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
i64 = ctypes.c_int64
u64 = ctypes.c_uint64
ci = ctypes.c_int


@lru_cache(maxsize=1)
def _lib():
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.clover_host_version.restype = ci
    lib.clover_xs_init.argtypes = [u64, u64, ci, u64p, u64p]
    lib.clover_xs_stream.argtypes = [u64, u64, ci, u64p]
    for name in ("clover_quantize_vec4", "clover_quantize_vec8"):
        getattr(lib, name).argtypes = [f32p, i64, i8p, f32p, ci, u64, u64]
    for name in ("clover_restore_vec4", "clover_restore_vec8"):
        getattr(lib, name).argtypes = [i8p, f32p, i64, f32p]
    for name in ("clover_dot4", "clover_dot8"):
        fn = getattr(lib, name)
        fn.argtypes = [i8p, f32p, i8p, f32p, i64]
        fn.restype = ctypes.c_float
    lib.clover_quantize_mat4.argtypes = [f32p, i64, i64, i8p, f32p, ci,
                                         u64, u64]
    lib.clover_mvm4.argtypes = [i8p, f32p, i8p, f32p, i64, i64, i8p, f32p]
    lib.clover_threshold4.argtypes = [i8p, f32p, i64, i64, i64]
    return lib


def available() -> bool:
    return _lib() is not None


def xs_stream(s0: int, s1: int, n: int) -> np.ndarray:
    out = np.zeros(n, np.uint64)
    _lib().clover_xs_stream(u64(s0), u64(s1), n, out)
    return out


def xs_init(key1: int, key2: int, lanes: int = 8):
    s0 = np.zeros(lanes, np.uint64)
    s1 = np.zeros(lanes, np.uint64)
    _lib().clover_xs_init(u64(key1), u64(key2), lanes, s0, s1)
    return s0, s1


def _pad(x: np.ndarray, mult: int = 128) -> np.ndarray:
    n = len(x)
    npad = -(-n // mult) * mult
    if npad == n:
        return np.ascontiguousarray(x, np.float32)
    out = np.zeros(npad, np.float32)
    out[:n] = x
    return out


def quantize_vec(x: np.ndarray, bits: int, sr: bool = False,
                 seed: tuple[int, int] = (0, 0)):
    """f32[n] -> (packed codes int8, scales f32); formats.py-compatible."""
    xp = _pad(np.asarray(x, np.float32))
    nb = len(xp) // 64
    scales = np.zeros(nb, np.float32)
    if bits == 4:
        codes = np.zeros(len(xp) // 2, np.int8)
        _lib().clover_quantize_vec4(xp, len(xp), codes, scales,
                                    int(sr), u64(seed[0]), u64(seed[1]))
    elif bits == 8:
        codes = np.zeros(len(xp), np.int8)
        _lib().clover_quantize_vec8(xp, len(xp), codes, scales,
                                    int(sr), u64(seed[0]), u64(seed[1]))
    else:
        raise ValueError(bits)
    return codes, scales


def restore_vec(codes: np.ndarray, scales: np.ndarray, bits: int):
    n_pad = len(codes) * (2 if bits == 4 else 1)
    out = np.zeros(n_pad, np.float32)
    fn = _lib().clover_restore_vec4 if bits == 4 else _lib().clover_restore_vec8
    fn(np.ascontiguousarray(codes), np.ascontiguousarray(scales), n_pad, out)
    return out


def dot(uc, us, vc, vs, bits: int) -> float:
    n_pad = len(uc) * (2 if bits == 4 else 1)
    fn = _lib().clover_dot4 if bits == 4 else _lib().clover_dot8
    return float(fn(np.ascontiguousarray(uc), np.ascontiguousarray(us),
                    np.ascontiguousarray(vc), np.ascontiguousarray(vs),
                    n_pad))


def quantize_mat4(a: np.ndarray, sr: bool = False,
                  seed: tuple[int, int] = (0, 0)):
    a = np.asarray(a, np.float32)
    m, n = a.shape
    mp, np_ = -(-m // 128) * 128, -(-n // 128) * 128
    ap = np.zeros((mp, np_), np.float32)
    ap[:m, :n] = a
    codes = np.zeros((mp, np_ // 2), np.int8)
    scales = np.zeros((mp // 64, np_ // 64), np.float32)
    _lib().clover_quantize_mat4(np.ascontiguousarray(ap.ravel()), mp, np_,
                                codes.reshape(-1), scales.reshape(-1),
                                int(sr), u64(seed[0]), u64(seed[1]))
    return codes, scales


def mvm4(ac, as_, xc, xs, m_pad: int, n_pad: int):
    yc = np.zeros(m_pad // 2, np.int8)
    ys = np.zeros(m_pad // 64, np.float32)
    _lib().clover_mvm4(np.ascontiguousarray(ac.reshape(-1)),
                       np.ascontiguousarray(as_.reshape(-1)),
                       np.ascontiguousarray(xc), np.ascontiguousarray(xs),
                       m_pad, n_pad, yc, ys)
    return yc, ys


def threshold4(codes, scales, length: int, k: int):
    codes = np.ascontiguousarray(codes).copy()
    _lib().clover_threshold4(codes, np.ascontiguousarray(scales),
                             len(codes) * 2, length, k)
    return codes
