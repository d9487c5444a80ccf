"""Bytes and operations of the stem max pool's backward, kernel #16 (a
frozen copy of `chip_smoke.py::pool_cost`): x [B, H, W, C] read once,
the cotangent [B, ho, wo, C] read once, dx written once; 9 compares and
an add a cotangent. `step_bound_ms` sums the two stems of a DGL step."""

from __future__ import annotations

from portbench.harness import peaks


def pool_cost(shape, itemsize: int):
    b, h, w, c = shape
    g = b * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c
    return (2 * b * h * w * c + g) * itemsize, 10 * g


def stem_shapes(config: dict, clips: int):
    """The pool's input [B, H, W, C] of the audio and the visual stem."""
    a = config["audio"]
    f = a["n_fft"] // 2 + 1
    t = 1 + a["sample_rate"] * a["seconds"] // a["hop"]
    width = config["widths"]["width"]
    return ([clips, (f - 1) // 2 + 1, (t - 1) // 2 + 1, width],
            [clips * config["frames"], 112, 112, width])


def step_bound_ms(config: dict, clips: int) -> float:
    """In float32: 4 bytes an element."""
    return sum(peaks.bound_ms(*pool_cost(s, 4))
               for s in stem_shapes(config, clips))
