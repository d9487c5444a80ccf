"""Dependency-free WAV decode + resample.

Replaces librosa.load (dataset/CramedDataset.py:60 etc.; librosa is not in
this image). RIFF/WAVE parsing is plain numpy (PCM 8/16/24/32 and float32/
float64); multi-channel is averaged to mono and resampling uses scipy's
polyphase filter (librosa's own high-quality modes are polyphase too; the
STFT numerics downstream are golden-tested independently in test_ops.py).
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np


def _decode_pcm(raw: bytes, bits: int, fmt: int) -> np.ndarray:
    if fmt == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        return np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if bits == 8:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if bits == 16:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        return val.astype(np.float32) / float(1 << 23)
    if bits == 32:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"unsupported WAV bit depth {bits}")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (mono float32 samples in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            audio_fmt, channels, rate, _, _, bits = struct.unpack(
                "<HHIIHH", body[:16])
            if audio_fmt == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_fmt = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_fmt, channels, rate, bits)
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, bits = fmt
    wave = _decode_pcm(samples, bits, audio_fmt)
    if channels > 1:
        wave = wave[: len(wave) - len(wave) % channels]
        wave = wave.reshape(-1, channels).mean(axis=1)
    return wave, rate


def resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wave
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wave, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(path: str, sr: int) -> np.ndarray:
    """librosa.load(path, sr=sr, mono=True) capability."""
    wave, rate = read_wav(path)
    return resample(wave, rate, sr)
