"""Bytes and operations of the window-attention kernels (a frozen copy
of `chip_smoke.py::attention_cost`): every input read once, every output
written once; 2 operations a multiply-add of the products, 5 a softmax
element. `pass_bound_ms` sums each launch's bound over one pass of a
Swin encoder pair: the audio encoder over `audio_images`, the visual one
over `visual_images`, every block one launch, odd blocks masked where
the window does not cover the map."""

from __future__ import annotations

from portbench.harness import peaks

N = 49  # tokens a 7 × 7 window


def attention_cost(kind: str, bw: int, c: int, heads: int, masked: bool,
                   res: int, itemsize: int):
    """(bytes, operations) of one launch over `bw` windows of `c` channels:
    kind 'eval' (#1: x, W, b, bias, mask in; out out), 'savep' (#2: also
    the qkv and p residuals out) or 'bwd' (#4: qkv, p, dout in; dqkv,
    dbias out)."""
    tokens, scores = bw * N * c, bw * heads * N * N
    small = heads * N * N * 4  # the bias, or dbias, in float32
    nw = (res // 7) ** 2 if masked else 0
    if kind == "bwd":
        return ((3 * tokens + scores + tokens + 3 * tokens) * itemsize
                + small, 8 * bw * N * N * c + 6 * scores)
    nbytes = (2 * tokens + 3 * c * c + 3 * c) * itemsize + small \
        + nw * N * N * 4
    if kind == "savep":
        nbytes += (3 * tokens + scores) * itemsize
    return nbytes, 2 * bw * N * c * 3 * c + 4 * bw * N * N * c + 5 * scores


def pass_bound_ms(kind: str, config: dict, audio_images: int,
                  visual_images: int) -> float:
    """In float32: 4 bytes an element."""
    wd = config["widths"]
    res0 = 224 // wd["patch"]
    total = 0.0
    for images in (audio_images, visual_images):
        for s, depth in enumerate(wd["depths"]):
            c, res = wd["embed_dim"] * 2 ** s, res0 // 2 ** s
            bw = images * (res // wd["window"]) ** 2
            for i in range(depth):
                masked = i % 2 == 1 and res > wd["window"]
                total += peaks.bound_ms(*attention_cost(
                    kind, bw, c, wd["heads"][s], masked, res, 4))
    return total
