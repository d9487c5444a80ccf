"""ctypes binding for the native host-pipeline kernels (native/gdl_host.cpp).

Auto-builds native/libgdlhost.so with g++ on first use when missing (the
image ships no pybind11; ctypes releases the GIL per call, so the loader's
thread pool scales decode/resample across cores). Falls back silently to
the pure-Python path (data/wav.py) when no compiler is available.

The polyphase taps and scipy-compatible upfirdn slicing (skip / n_out) are
computed here exactly as scipy.signal.resample_poly does, so the native
resampler matches the scipy path to float32 rounding (tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "gdl_host.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libgdlhost.so")
_IMG_SRC = os.path.join(_REPO_ROOT, "native", "gdl_image.cpp")
_IMG_SO = os.path.join(_REPO_ROOT, "native", "libgdlimage.so")
_lock = threading.Lock()
_lib = None
_tried = False
_img_lib = None
_img_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8cp = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared",
             "-std=c++17", "-pthread", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GDL_DISABLE_NATIVE"):
            return None
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.gdl_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.gdl_wav_read.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int32]
        lib.gdl_upfirdn.argtypes = [
            _f32p, ctypes.c_int32, _f32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _f32p, ctypes.c_int32]
        lib.gdl_wav_to_fixed.argtypes = [
            ctypes.c_char_p, _f32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _f32p]
        if hasattr(lib, "gdl_collate_cached"):  # absent in stale builds
            lib.gdl_collate_cached.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), _i64p, _i64p, _i64p, _i64p,
                ctypes.c_int32, _f32p, ctypes.POINTER(ctypes.c_char_p),
                _i64p, _i32p, ctypes.c_int32, ctypes.c_int64, _u8cp,
                ctypes.c_int32, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


@functools.lru_cache(maxsize=32)
def _poly_filter(up: int, down: int) -> Tuple[np.ndarray, int, int]:
    """(padded taps, half_len, n_pre_remove) per scipy resample_poly."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h]).astype(np.float32)
    return np.ascontiguousarray(h), half_len, n_pre_remove


def _resample_params(n_in: int, orig_sr: int, target_sr: int):
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return 1, 1, np.zeros(1, np.float32), 0, n_in
    h, _, skip = _poly_filter(up, down)
    n_out = n_in * up // down + bool((n_in * up) % down)
    return up, down, h, skip, n_out


def wav_info(path: str) -> Tuple[int, int]:
    lib = get_lib()
    n = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.gdl_wav_info(path.encode(), ctypes.byref(n), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"{path}: native WAV parse failed ({rc})")
    return int(n.value), int(rate.value)


def load_wav(path: str, sr: int) -> np.ndarray:
    """Native librosa.load(path, sr) equivalent."""
    lib = get_lib()
    n_in, rate = wav_info(path)
    raw = np.empty(n_in, np.float32)
    frames = lib.gdl_wav_read(path.encode(), raw, n_in)
    if frames < 0:
        raise ValueError(f"{path}: native WAV read failed ({frames})")
    raw = raw[:frames]
    if rate == sr:
        return raw
    up, down, h, skip, n_out = _resample_params(frames, rate, sr)
    out = np.empty(n_out, np.float32)
    lib.gdl_upfirdn(np.ascontiguousarray(raw), frames, h, len(h), up, down,
                    skip, out, n_out)
    return out


def wav_to_fixed(path: str, sr: int, target_len: int, tile: int,
                 start: int = 0) -> Optional[np.ndarray]:
    """Fused decode + resample + tile/crop/clip. Returns None when the
    native library is unavailable (caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    n_in, rate = wav_info(path)
    up, down, h, skip, n_out = _resample_params(n_in, rate, sr)
    out = np.empty(target_len, np.float32)
    rc = lib.gdl_wav_to_fixed(path.encode(), h, len(h), up, down, skip,
                              n_out, tile, start, target_len, out)
    if rc != 0:
        raise ValueError(f"{path}: native pipeline failed ({rc})")
    return out


_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def get_image_lib() -> Optional[ctypes.CDLL]:
    """libjpeg-backed JPEG decode+resize. OPT-IN (GDL_NATIVE_JPEG=1): its
    resampling filter differs per-pixel from PIL's antialiased bilinear —
    an augmentation-level delta, kept off the default path."""
    global _img_lib, _img_tried
    if not os.environ.get("GDL_NATIVE_JPEG"):
        return None  # opt-in is dynamic — don't cache the disabled case
    if _img_lib is not None or _img_tried:
        return _img_lib
    with _lock:
        if _img_lib is not None or _img_tried:
            return _img_lib
        _img_tried = True
        if not os.path.exists(_IMG_SO):
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fPIC", "-shared",
                     "-std=c++17", "-o", _IMG_SO, _IMG_SRC, "-ljpeg"],
                    check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_IMG_SO)
        except OSError:
            return None
        lib.gdl_jpeg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, _u8p]
        _img_lib = lib
        return _img_lib


def collate_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "gdl_collate_cached")


def collate_cached(apaths, aoff, alen, tiled_len, starts, target,
                   fpaths, foff, rows, n_frames, row_bytes,
                   nthreads: int = 1):
    """Batched pure-IO collate over the offline cache (one GIL-released C
    call per batch): preads the cached waveforms + the selected frame rows
    straight into the final batch buffers and applies the tile/crop/clip
    audio tail (native/gdl_host.cpp gdl_collate_cached). Every RNG draw
    (crop starts, frame row selection) happens in the CALLER — output is
    bitwise-equal to the per-sample Python path (tests/test_preprocessed.py).

    Returns (wave [B, target] f32, frames [B, n_frames*row_bytes] u8 flat)
    or None when the native library lacks the entry point; raises
    ValueError on any file IO failure (caller falls back per-sample)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdl_collate_cached"):
        return None
    batch = len(apaths)
    wave = np.empty((batch, target), np.float32)
    frames = np.empty((batch, n_frames * row_bytes), np.uint8)
    ap = (ctypes.c_char_p * batch)(*[p.encode() for p in apaths])
    fp = (ctypes.c_char_p * batch)(*[p.encode() for p in fpaths])
    rc = lib.gdl_collate_cached(
        ap, np.ascontiguousarray(aoff, np.int64),
        np.ascontiguousarray(alen, np.int64),
        np.ascontiguousarray(tiled_len, np.int64),
        np.ascontiguousarray(starts, np.int64), target, wave, fp,
        np.ascontiguousarray(foff, np.int64),
        np.ascontiguousarray(rows, np.int32), n_frames, row_bytes, frames,
        batch, nthreads)
    if rc != 0:
        raise ValueError(f"native collate failed at sample {-rc - 1}")
    return wave, frames


def decode_jpeg(path: str, size: int) -> Optional[np.ndarray]:
    """[size, size, 3] uint8, or None when the native path is unavailable
    (caller falls back to PIL)."""
    lib = get_image_lib()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.gdl_jpeg_decode_resize(path.encode(), size, out)
    if rc != 0:
        raise ValueError(f"{path}: native JPEG decode failed ({rc})")
    return out
