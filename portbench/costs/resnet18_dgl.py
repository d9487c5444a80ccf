"""Model FLOPs of the dual ResNet-18 DGL classifier: convolutions and
the head's products, 2 operations a multiply-add. A training step
counts the forward once and both gradients of every product (the input
and the weight gradient), except the stems' input gradients, which
nothing needs, and the head's as the DGL step takes them (the unimodal
logits' input gradient, the fused logits' weight gradient). BatchNorm,
ReLU, pooling and the loss are not counted, nor anything recomputed."""

from __future__ import annotations


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def encoder_macs(in_chans: int, h: int, w: int, width: int = 64,
                 stages=(2, 2, 2, 2)):
    """(total multiply-adds of one image's forward, the stem's)."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    stem = in_chans * width * 49 * h * w
    total = stem
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = width
    for s, depth in enumerate(stages):
        cout = width * 2 ** s
        for i in range(depth):
            stride = 2 if (s > 0 and i == 0) else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            total += cin * cout * 9 * ho * wo + cout * cout * 9 * ho * wo
            if stride != 1 or cin != cout:
                total += cin * cout * ho * wo
            h, w, cin = ho, wo, cout
    return total, stem


def _spec(config: dict):
    a = config["audio"]
    samples = a["sample_rate"] * a["seconds"]
    return a["n_fft"] // 2 + 1, 1 + samples // a["hop"]


def _parts(config: dict):
    wd = config["widths"]
    f, t = _spec(config)
    audio = encoder_macs(1, f, t, wd["width"], wd["stages"])
    visual = encoder_macs(3, 224, 224, wd["width"], wd["stages"])
    dim = wd["width"] * 2 ** (len(wd["stages"]) - 1)
    return audio, visual, dim, config["n_classes"]


def eval_flops(config: dict, clips: int) -> float:
    (a, _), (v, _), dim, n = _parts(config)
    head = 4 * dim * n  # out_a, out_v over D each, out over 2D
    return 2.0 * clips * (a + config["frames"] * v + head)


def train_flops(config: dict, clips: int) -> float:
    (a, a_stem), (v, v_stem), dim, n = _parts(config)
    frames = config["frames"]
    encoders = 3 * (a + frames * v) - (a_stem + frames * v_stem)
    head = 4 * dim * n + 2 * dim * n + 2 * dim * n
    return 2.0 * clips * (encoders + head)
