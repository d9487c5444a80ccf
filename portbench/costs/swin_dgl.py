"""Model FLOPs of the dual Swin DGL classifier: the patch embedding, the
blocks' qkv, attention scores and values, projection and MLP products,
the patch mergings' reductions and the head, 2 operations a
multiply-add. A training step counts the forward once and both
gradients of every product, except the patch embeddings' input
gradients and the head's as the DGL step takes them. Norms, softmax,
GELU and the loss are not counted, nor anything recomputed."""

from __future__ import annotations


def encoder_macs(in_chans: int, img: int = 224, patch: int = 4,
                 dim: int = 128, depths=(2, 2, 18, 2), window: int = 7):
    """(multiply-adds of one image's forward, the patch embedding's)."""
    res = img // patch
    embed = in_chans * dim * patch * patch * res * res
    total = embed
    for s, depth in enumerate(depths):
        c, r = dim * 2 ** s, res // 2 ** s
        tokens, n = r * r, min(window, r) ** 2
        total += depth * tokens * (12 * c * c + 2 * n * c)
        if s < len(depths) - 1:
            total += tokens * 4 * c * 2 * c // 4
    return total, embed


def _parts(config: dict):
    wd = config["widths"]
    kw = dict(patch=wd["patch"], dim=wd["embed_dim"], depths=wd["depths"],
              window=wd["window"])
    dim = wd["embed_dim"] * 2 ** (len(wd["depths"]) - 1)
    return (encoder_macs(1, **kw), encoder_macs(3, **kw), dim,
            config["n_classes"])


def eval_flops(config: dict, clips: int) -> float:
    (a, _), (v, _), dim, n = _parts(config)
    return 2.0 * clips * (a + config["frames"] * v + 4 * dim * n)


def train_flops(config: dict, clips: int) -> float:
    (a, a_embed), (v, v_embed), dim, n = _parts(config)
    frames = config["frames"]
    encoders = 3 * (a + frames * v) - (a_embed + frames * v_embed)
    return 2.0 * clips * (encoders + 8 * dim * n)
