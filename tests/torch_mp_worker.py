"""The model-parallel scenarios of tests/test_torch_model_parallel.py, run
by each rank of a four-rank gloo group laid out as `--dp 2 --mp 2`.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_mp_worker.py OUT_DIR INIT_PTH MM_PTH

runs every scenario of `run_all` on this rank and writes
OUT_DIR/<scenario>_rank<r>.pt. INIT_PTH holds the flagship's initial
weights (a state dict); MM_PTH a tiny mmformer_n's initial weights and
the PE noise of its one step ({"state", "noise"}). The trainings are
tests/torch_dist_worker.py's, with `--dp 2 --mp 2` and every state
written whole (`full_state_dict`). Imports neither jax nor gdl_tpu.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

from gdl_tpu_torch.config import Config  # noqa: E402
from gdl_tpu_torch.parallel import distributed as dist  # noqa: E402
from gdl_tpu_torch.parallel import mesh  # noqa: E402
from gdl_tpu_torch.parallel import row_parallel as rp  # noqa: E402

DP, MP = 2, 2
GRID = dict(dp=DP, mp=MP)
SHORT = dict(epochs=1)  # the joint run: one epoch of four steps


def _whole(model):
    return {k: v.detach().clone() for k, v in rp.full_state_dict(model)
            .items()}


def _local(model):
    """This rank's own tensors: the shards, and a digest of the rest."""
    shards = {n + ".weight": m.weight.detach().clone()
              for n, m in model.named_modules()
              if isinstance(m, rp.RowParallelLinear)}
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        if k not in shards:
            digest.update(k.encode())
            digest.update(v.detach().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes())
    return shards, digest.hexdigest()


def _keeping_model(fn, *args, **kw):
    """fn's result with its model's whole state ("state") and its own
    tensors ("shards", "digest"): W's trainings build their model inside,
    so `W._state` is wrapped to see it."""
    box = {}
    inner = W._state

    def whole(model):
        box["model"] = model
        return _whole(model)

    W._state = whole
    try:
        out = fn(*args, **kw)
    finally:
        W._state = inner
    out["shards"], out["digest"] = _local(box["model"])
    return out


def flagship(workdir, init, **kw):
    return _keeping_model(W.flagship, workdir, init, **dict(GRID, **kw))


def swin(workdir, fuse_mlp=False, **kw):
    """The tiny Swin DGL classifier of W.swin; with --fuse_mlp 1 each
    block's MLP runs `mlp_fused` (its plain version here), under --mp on
    fc2's gathered weight. `kw` overrides the Config."""
    from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL

    cfg = Config(**dict(W.KW, ckpt_path="ckpt", fuse_mlp=fuse_mlp,
                        **W.SWIN_TINY, **kw))
    model = AVClassifierSwinDGL(cfg, drop_path_rate=0.1,
                                generator=torch.Generator().manual_seed(6))
    log, gen = W._training(workdir, cfg, model,
                           W.PreTensorSet(8, 2, (32, 32, 1), (2, 32, 32, 3)),
                           W.PreTensorSet(4, 3, (32, 32, 1), (2, 32, 32, 3)))
    return dict(state=W._state(model), log=log, gen=gen)


def mm_jax(mm, batch):
    """One AUXI step of a tiny mmformer_n (shared streams) from gdl_tpu's
    initial weights, without dropout, the PE heads fed the given global
    noise (each rank its rows): against gdl_tpu's make_mesh(2, 2) step."""
    from gdl_tpu_torch.models import classifier as port_classifier
    from gdl_tpu_torch.models import intermediate as port_inter
    from gdl_tpu_torch.models import transformer as port_tr
    from gdl_tpu_torch.train.auxi import make_auxi_train_step
    from gdl_tpu_torch.train.loop import assemble_harness

    cfg = Config(**dict(W.KW, alpha=2.0, beta=0.05, learning_rate=0.05,
                        fps=1, log_grad_csv=False, **GRID))
    model, kind = port_inter.build_intermediate(
        "mmformer_n", W.N_CLASSES, width=8, embed_dim=128, seq_len=16,
        share_streams=True)
    model.load_state_dict(mm["state"], strict=True)
    for mod in model.modules():
        if isinstance(mod, port_tr.Drop):
            mod.rate = 0.0
        if isinstance(mod, port_tr.SelfAttention):
            mod.dropout_rate = 0.0
    draws = itertools.cycle(mm["noise"])
    inner = port_classifier.pe_noise
    port_classifier.pe_noise = lambda shape, gen, dev: dist.local_rows(
        lambda k: torch.from_numpy(next(draws)), shape[0])

    def make_step(model, optimizer, preprocess, generator):
        return make_auxi_train_step(model, cfg, optimizer, seven_tuple=True,
                                    generator=generator, av_inputs=False)

    try:
        h = assemble_harness(cfg, model, 2, make_step, raw_batches=False)
        index, size = mesh.data_index(), mesh.data_size()
        rows = batch["label"].shape[0] // size
        local = {k: torch.from_numpy(v[index * rows:(index + 1) * rows])
                 for k, v in batch.items()}
        m = h.train_step(local)
    finally:
        port_classifier.pe_noise = inner
    return dict(state=_whole(model), loss=float(m["loss"]))


def masks():
    """A dropout mask and a batch draw of this rank, in the element layout
    and rows of its data index."""
    from gdl_tpu_torch.ops.dropout import prng_dropout_mask

    words = torch.tensor([2024, -7], dtype=torch.int32)
    shape = (4 // DP, 3, 5, 8)
    numel = shape[0] * 3 * 5 * 8
    gen = torch.Generator().manual_seed(12)
    return dict(
        mask=prng_dropout_mask(words, shape, 0.3,
                               offset=dist.element_layout(numel)),
        rows=dist.local_rows(lambda k: torch.rand((k, 3), generator=gen),
                             shape[0]),
        coords=(mesh.data_index(), mesh.model_index()))


def linear():
    """The row-parallel linear against the inputs of
    `linear_inputs`: y and the gradients of x, the shard and the bias;
    x's gradient through the detached weights; and `gather_columns`."""
    x, w, b, g, gw = linear_inputs()
    layer = rp.RowParallelLinear.from_linear(_linear(w, b), mesh.model_index(),
                                             MP)
    xs = x.clone().requires_grad_(True)
    y = layer(xs)
    (y * g).sum().backward()
    xd = x.clone().requires_grad_(True)
    yd = rp.row_parallel_linear(xd, layer.weight.detach(), layer.bias.detach())
    (yd * g).sum().backward()
    shard = layer.weight.detach().clone().requires_grad_(True)
    whole = rp.gather_columns(shard)
    (whole * gw).sum().backward()
    return dict(y=y.detach(), dx=xs.grad, dw=layer.weight.grad,
                db=layer.bias.grad, y_detached=yd.detach(),
                dx_detached=xd.grad, gathered=whole.detach(),
                gathered_grad=shard.grad,
                index=mesh.model_index())


def linear_inputs():
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((3, 4, 8), generator=gen)
    w = torch.randn((5, 8), generator=gen)
    b = torch.randn((5,), generator=gen)
    g = torch.randn((3, 4, 5), generator=gen)
    gw = torch.randn((5, 8), generator=gen)
    return x, w, b, g, gw


def _linear(w, b):
    layer = torch.nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


def converted():
    """The names `convert_row_parallel` swaps, per model family."""
    from gdl_tpu_torch.models import classifier as C
    from gdl_tpu_torch.models import intermediate as I

    out = {}
    for name, model in family_models(C, I).items():
        out[name] = sorted(rp.convert_row_parallel(model))
    return out


def family_models(C, I):
    """Each model family of the port at the tests' tiny sizes."""
    base = dict(W.KW, fps=1, log_grad_csv=False)
    models = {}
    for fusion in ("concat", "sum", "film", "gated"):
        cfg = Config(**dict(base, fusion_method=fusion))
        models[f"dgl-{fusion}"] = C.AVClassifierDGL(cfg)
        models[f"joint-{fusion}"] = C.AVClassifier(cfg)
    for modality in ("audio", "visual"):
        models[f"dgl-{modality}"] = C.AVClassifierDGL(
            Config(**dict(base, modality=modality)))
    swin = Config(**dict(base, **W.SWIN_TINY))
    models["swin-dgl"] = C.AVClassifierSwinDGL(swin)
    models["swin-joint"] = C.AVClassifierSwin(swin)
    models["mmformer_n"] = I.MMFormerN(**W.MMF)
    models["mmtm"] = I.MMTMNet(W.N_CLASSES, 8)
    models["sefusion"] = I.SEFusionNet(W.N_CLASSES, 8)
    models["mmformer"] = I.MMFormer(**W.MMF)
    return models


def resume(workdir, init):
    """One epoch of the flagship saving its resume state and a best
    checkpoint (written whole by rank 0), then the run resumed from the
    resume state on the four ranks to the end of epoch 1."""
    from gdl_tpu_torch.models.classifier import AVClassifierDGL
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    ckpt = os.path.join(workdir, "ckpt")  # shared by the ranks
    cwd = os.path.join(workdir, f"cwd{dist.process_index()}")
    kw = dict(W.KW, ckpt_path=ckpt, log_grad_csv=False, **GRID)
    cfg = Config(**dict(kw, epochs=1, save_every=1))
    model = AVClassifierDGL(cfg)
    model.load_state_dict(init)
    first, _ = W._training(cwd, cfg, model, W.PreTensorSet(16, 0),
                           W.PreTensorSet(8, 1))
    best = save_best_checkpoint(cfg, model, 0, 0.5,
                                path=os.path.join(ckpt, "best.pth"))
    state = os.path.join(ckpt, "resume_state.pth")
    cfg2 = Config(**dict(kw, resume=state))
    model2 = AVClassifierDGL(cfg2, generator=torch.Generator().manual_seed(8))
    rest, gen = W._training(cwd, cfg2, model2, W.PreTensorSet(16, 0),
                            W.PreTensorSet(8, 1))
    return dict(first=first, rest=rest, state=_whole(model2), gen=gen,
                best=best, resume_state=state)


def refusals():
    """check_supported under four ranks: --dp 3 with --mp 2, --mp 3, and
    a global batch that the two data indices cannot split."""
    from gdl_tpu_torch.train.loop import check_supported

    out = {}
    for name, kw in (("dp3", dict(dp=3, mp=2)), ("mp3", dict(mp=3)),
                     ("batch3", dict(batch_size=3, mp=2))):
        try:
            check_supported(Config(**dict(W.KW, **kw)))
            out[name] = None
        except Exception as e:  # the message is what the test reads
            out[name] = f"{type(e).__name__}: {e}"
    return out


def run_all(out_dir, init, mm):
    r = dist.process_index()
    work = os.path.join(out_dir, "work")
    mesh.init_grid(MP)  # before any model with per-replica BatchNorm
    scenarios = {
        "grid": lambda: dict(coords=(mesh.data_index(), mesh.data_size(),
                                     mesh.model_index(), mesh.model_size())),
        "refusals": refusals,
        "linear": linear,
        "masks": masks,
        "converted": converted,
        "sync": lambda: flagship(os.path.join(work, f"sync{r}"), init),
        "nosync": lambda: flagship(os.path.join(work, f"nosync{r}"), init,
                                   sync_bn=False, epochs=1),
        "joint": lambda: _keeping_model(W.joint, os.path.join(
            work, f"joint{r}"), **GRID, **SHORT),
        "swin": lambda: _keeping_model(swin, os.path.join(work, f"swin{r}"),
                                       **GRID),
        "swin_fused": lambda: _keeping_model(
            swin, os.path.join(work, f"swinf{r}"), fuse_mlp=True, **GRID),
        "mmformer": lambda: _keeping_model(W.mmformer, epochs=1, **GRID),
        "mm_jax": lambda: mm_jax(mm, mm["batch"]),
        "resume": lambda: resume(os.path.join(work, "resume"), init),
    }
    for name, fn in scenarios.items():
        result = fn()
        torch.save(result, os.path.join(out_dir, f"{name}_rank{r}.pt"))


def main(argv):
    out_dir, init_path, mm_path = argv
    torch.set_num_threads(1)
    if not dist.maybe_initialize(device="cpu"):
        raise SystemExit("no process group: set RANK / WORLD_SIZE / "
                         "MASTER_ADDR / MASTER_PORT")
    try:
        run_all(out_dir, torch.load(init_path),
                torch.load(mm_path, weights_only=False))
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
