"""The model-parallel grid of the port (`--mp`, `gdl_tpu_torch/parallel/
mesh.py` and `row_parallel.py`) over four gloo ranks on the CPU laid out
as `--dp 2 --mp 2`, against the port's one-process run of the global
batch and against gdl_tpu's `make_mesh(2, 2)` program.

The four ranks run every scenario of `tests/torch_mp_worker.py` once
(one process group, batch 4 global, 2 a data index); the test process
runs the one-process references and the gdl_tpu references (jitted, on 4
of the 8 CPU devices, from one initial state).

Tolerances: four ranks against one process, parameters, BN buffers and
epoch means rtol 2e-5 (the split products and the sums over the batch
run in another order), accuracies and generator states exact; against
gdl_tpu 5e-4 (tests/test_torch_distributed.py's bars); the row-parallel
linear against F.linear 1e-6; masks, shards and the resumed run bit for
bit. `--sync_bn 0` has no one-process form in the port (per-replica
statistics need the replicas), so it is held to gdl_tpu's grouped
BatchNorm under the same mesh."""

import itertools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models import classifier as jax_classifier
from gdl_tpu.models import intermediate as jax_inter
from gdl_tpu.models import transformer as jax_tr
from gdl_tpu.parallel.mesh import (
    _param_spec,
    batch_sharding,
    make_mesh,
    state_sharding,
)
from gdl_tpu.train import auxi as jax_auxi
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models import classifier as port_classifier
from gdl_tpu_torch.models import intermediate as port_inter
from gdl_tpu_torch.parallel.mesh import is_row_parallel
from gdl_tpu_torch.train.optim import make_optimizer
from gdl_tpu_torch.utils.checkpoint import (
    load_best_checkpoint,
    load_train_state,
)
from gdl_tpu_torch.utils.interop import _torch_components, state_dict_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402
import torch_mp_worker as MPW  # noqa: E402
from tests.test_torch_distributed import (  # noqa: E402
    JAX_RTOL,
    RTOL,
    _close_logs,
    _close_states,
    _jax_init,
    _jax_cfg,
    _jax_run,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")
WORLD = 4
MM_KW = dict(dataset="CREMAD", alpha=2.0, beta=0.05, learning_rate=0.05,
             lr_decay_step=[2], encoder_width=8, fps=1, log_grad_csv=False,
             batch_size=4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out_dir, init_path, mm_path, timeout=400):
    """Every scenario on four gloo ranks → {scenario: [result per rank]}."""
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out_dir, init_path, mm_path],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    logs = [open(os.path.join(out_dir, f"rank{r}.log")).read()
            for r in range(WORLD)]
    assert codes == [0] * WORLD, "\n".join(logs)[-6000:]
    names = sorted({f.rsplit("_rank", 1)[0] for f in os.listdir(out_dir)
                    if f.endswith(".pt")})
    return {n: [torch.load(os.path.join(out_dir, f"{n}_rank{r}.pt"),
                           weights_only=False) for r in range(WORLD)]
            for n in names}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _mm_setup():
    """A tiny mmformer_n of gdl_tpu (shared streams): its jitted initial
    variables, the PE noise of one step (rgb_p, then depth_p) and one
    global batch of 4."""
    model, _ = jax_inter.build_intermediate(
        "mmformer_n", 6, width=8, embed_dim=128, seq_len=16,
        share_streams=True)
    rng = np.random.default_rng(31)
    batch = {"audio": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
             "visual": rng.standard_normal((4, 64, 64, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 6, 4).astype(np.int32)}
    noise = [rng.standard_normal((4, 4, 4, 16)).astype(np.float32)
             for _ in range(2)]
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "drop": k, "dropout": k, "pe": k}, batch["audio"],
        batch["visual"], train=False, av_inputs=False))(k)
    return model, _np_tree(variables), noise, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, the flagship's initial weights (gdl_tpu's
    init) and the mmformer_n set-up."""
    out = tmp_path_factory.mktemp("mp_ranks")
    params, stats = _jax_init(_jax_cfg())
    init = state_dict_from_flax(params, stats)
    init_path = str(out / "init.pth")
    torch.save(init, init_path)
    mm_model, mm_vars, noise, batch = _mm_setup()
    mm_path = str(out / "mm.pth")
    torch.save(dict(state=state_dict_from_flax(
        mm_vars["params"], mm_vars.get("batch_stats", {})), noise=noise,
        batch=batch), mm_path)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = _launch(str(out), init_path, mm_path)
    finally:
        torch.set_num_threads(before)
    return dict(ranks=ranks, init=init, params=params, stats=stats,
                mm=(mm_model, mm_vars, noise, batch))


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _equal_everywhere(results, keys=("gen",)):
    """The whole states (and `keys`) are equal on every rank."""
    first = results[0]
    for other in results[1:]:
        for k in keys:
            assert torch.equal(first[k], other[k]), k
        for k in first["state"]:
            assert torch.equal(first["state"][k], other["state"][k]), k


def _shards_split_the_whole(results):
    """Each data index's two model ranks hold disjoint halves of every
    row-parallel weight: their columns put side by side are the whole
    weight, and the ranks of one model index hold the same shard. The
    replicated tensors digest alike on all four ranks."""
    whole = results[0]["state"]
    assert results[0]["shards"]
    for name in results[0]["shards"]:
        for d in range(2):
            a, b = (results[2 * d + m]["shards"][name] for m in range(2))
            assert a.shape[1] * 2 == whole[name].shape[1], name
            assert torch.equal(torch.cat([a, b], 1), whole[name]), name
    assert len({r["digest"] for r in results}) == 1


def test_grid_layout(runs):
    """rank = data index · 2 + model index, as create_device_mesh((2, 2))
    lays the devices out."""
    assert [r["coords"] for r in runs["ranks"]["grid"]] == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]


def test_flagship_sync_bn_matches_one_process_and_gdl_tpu_mesh(
        runs, tmp_path, monkeypatch, two_threads):
    """Two epochs of the flagship DGL run under --dp 2 --mp 2 with global
    BatchNorm: the four ranks agree bit for bit (whole weights,
    generator, accuracies), `fusion_module.fc_out` (and the unused
    `fc_auxi`) are split into two column halves, only rank 0 writes
    files; the run equals the one-process run of the global batch. Its
    first epoch (the resume scenario's, whose resume state holds the
    whole weights after it) equals gdl_tpu's make_mesh(2, 2) program."""
    results = runs["ranks"]["sync"]
    _equal_everywhere(results)
    _shards_split_the_whole(results)
    assert sorted(results[0]["shards"]) == [
        "fusion_module.fc_auxi.weight", "fusion_module.fc_out.weight"]
    assert len({str([a for *_, a in r["log"]]) for r in results}) == 1
    assert all(r["files"] == [] for r in results[1:])
    assert {"ckpt/CREMAD_full.csv",
            "audio_visual_grad_vanilla.csv"} <= set(results[0]["files"])

    one = W.flagship(str(tmp_path / "one"), runs["init"])
    _close_states(results[0]["state"], one["state"])
    _close_logs(results[0]["log"], one["log"])
    assert torch.equal(results[0]["gen"], one["gen"])

    first = runs["ranks"]["resume"][0]
    assert first["first"][0][2] == results[0]["log"][0][2]
    jlog, jstate = _jax_run(runs, tmp_path / "jax", monkeypatch, mp=2,
                            epochs=1)
    assert len(jlog) == len(first["first"]) == 1
    for (_, pm, pacc), (_, jm, jacc) in zip(first["first"], jlog):
        for k in ("loss", "loss_f", "loss_a", "loss_v", "grad_norm"):
            assert pm[k] == pytest.approx(float(jm[k]), rel=JAX_RTOL), k
        assert tuple(pacc) == pytest.approx(tuple(jacc), abs=1e-12)
    saved = torch.load(first["resume_state"], weights_only=False)["model"]
    _close_states(saved, jstate, rtol=0, atol=JAX_RTOL)


def test_flagship_per_replica_bn_matches_gdl_tpu_mesh(
        runs, tmp_path, monkeypatch, two_threads):
    """--sync_bn 0 under --dp 2 --mp 2: each data index normalises its own
    rows (gdl_tpu's GroupedBatchNorm with two groups); after one epoch
    the whole weights, equal on the four ranks, match gdl_tpu's
    make_mesh(2, 2) --sync_bn 0 run."""
    results = runs["ranks"]["nosync"]
    _equal_everywhere(results)
    _shards_split_the_whole(results)
    jlog, jstate = _jax_run(runs, tmp_path / "jax", monkeypatch,
                            sync_bn=False, mp=2, epochs=1)
    assert len(jlog) == len(results[0]["log"]) == 1
    _close_states(results[0]["state"], jstate, rtol=0, atol=JAX_RTOL)
    for (_, pm, pacc), (_, jm, jacc) in zip(results[0]["log"], jlog):
        assert pm["loss"] == pytest.approx(float(jm["loss"]), rel=JAX_RTOL)
        assert tuple(pacc) == pytest.approx(tuple(jacc), abs=1e-12)


@pytest.mark.parametrize("scenario", ["joint", "swin", "swin_fused",
                                      "mmformer"])
def test_trainings_match_one_process(runs, scenario, tmp_path, two_threads):
    """The joint lineage under OGM-GE with PE and the modality drop, the
    tiny Swin DGL classifier (plain MLP, and --fuse_mlp 1 on fc2's
    gathered weight) and the tiny mmformer_n under the AUXI step with its
    dropout masks, each under --dp 2 --mp 2: the four ranks agree bit for
    bit, the row-parallel weights (the heads, Swin's mlp.fc2, the
    transformers' ffn.fc2) are split into column halves, and the run
    equals the one-process run of the global batch, generator included."""
    results = runs["ranks"][scenario]
    _equal_everywhere(results)
    _shards_split_the_whole(results)
    if scenario.startswith("swin"):
        assert any(".mlp.fc2." in n for n in results[0]["shards"])
    if scenario == "mmformer":
        assert any(".ffn.fc2." in n for n in results[0]["shards"])
        one = W.mmformer(epochs=1)
    elif scenario == "joint":
        one = W.joint(str(tmp_path / "one"), **MPW.SHORT)
    else:
        one = MPW.swin(str(tmp_path / "one"),
                       fuse_mlp=scenario == "swin_fused")
    _close_states(results[0]["state"], one["state"])
    assert torch.equal(results[0]["gen"], one["gen"])
    if scenario == "mmformer":
        np.testing.assert_allclose(results[0]["losses"], one["losses"],
                                   rtol=RTOL)
    else:
        _close_logs(results[0]["log"], one["log"])


def test_mmformer_step_matches_gdl_tpu_mesh(runs, monkeypatch):
    """One AUXI step of a tiny mmformer_n (shared streams, no dropout, the
    PE noise fed alike) under --dp 2 --mp 2 against gdl_tpu's jitted step
    under make_mesh(2, 2), whose ffn.fc2 kernels are row-parallel over
    'model': the loss (the mean of the two data indices' row means) and
    the whole parameters after it."""
    model, variables, noise, batch = runs["mm"]
    cfg = JaxConfig(**MM_KW, dp=2, mp=2)
    opt = jax_optim.make_optimizer(cfg, 2, clip_norm=40.0)
    state = jax_dgl.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=opt.init(variables["params"]))
    draws = itertools.cycle(noise)
    monkeypatch.setattr(jax_tr.Drop, "__call__",
                        lambda self, x, deterministic: x)
    mesh = make_mesh(2, 2)
    shardings = state_sharding(state, mesh)
    kernel = shardings.params["inter"]["cross0"]["ffn"]["fc2"]["kernel"]
    assert kernel.spec == P("model", None)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(
                      next(draws)))
        step = jax.jit(jax_auxi.make_auxi_train_step(
            model, cfg, opt, seven_tuple=True,
            base_rng=jax.random.PRNGKey(0), av_inputs=False))
        new, metrics = step(
            jax.device_put(state, shardings),
            {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
             for k, v in batch.items()})
    want = state_dict_from_flax(_np_tree(new.params),
                                _np_tree(new.batch_stats))
    results = runs["ranks"]["mm_jax"]
    for r in results[1:]:
        for k, v in results[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    got = results[0]
    loss = (results[0]["loss"] + results[2]["loss"]) / 2  # its rows' mean
    assert loss == pytest.approx(float(metrics["loss"]), rel=JAX_RTOL)
    _close_states(got["state"], want, rtol=0, atol=JAX_RTOL)


def test_model_ranks_draw_equal_masks_and_rows(runs):
    """The two model ranks of a data index draw bit-equal dropout masks
    and batch rows (no activation is split over the model axis), and the
    two data indices' masks and rows are the global draw's rows."""
    from gdl_tpu_torch.ops.dropout import prng_dropout_mask

    results = runs["ranks"]["masks"]
    words = torch.tensor([2024, -7], dtype=torch.int32)
    whole = prng_dropout_mask(words, (4, 3, 5, 8), 0.3)
    rows = torch.rand((4, 3), generator=torch.Generator().manual_seed(12))
    for r, res in enumerate(results):
        d = r // 2
        assert res["coords"] == (d, r % 2)
        assert torch.equal(res["mask"], whole[2 * d:2 * d + 2])
        assert torch.equal(res["rows"], rows[2 * d:2 * d + 2])


def test_row_parallel_linear_matches_linear(runs):
    """y, dx, dW and db of each model rank's RowParallelLinear against
    F.linear on the whole weight: y, dx and db whole on both ranks, dW
    the rank's columns; through the detached weights the same y and dx;
    `gather_columns` gives the whole weight and keeps its columns of the
    whole gradient."""
    x, w, b, g, gw = MPW.linear_inputs()
    xs = x.clone().requires_grad_(True)
    ws = w.clone().requires_grad_(True)
    bs = b.clone().requires_grad_(True)
    y = F.linear(xs, ws, bs)
    (y * g).sum().backward()
    for res in runs["ranks"]["linear"]:
        cols = slice(4 * res["index"], 4 * res["index"] + 4)
        for name, want in (("y", y.detach()), ("dx", xs.grad),
                           ("db", bs.grad), ("dw", ws.grad[:, cols]),
                           ("y_detached", y.detach()),
                           ("dx_detached", xs.grad), ("gathered", w),
                           ("gathered_grad", gw[:, cols])):
            np.testing.assert_allclose(res[name].numpy(), want.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def _jax_families():
    """gdl_tpu's parameter shapes (eval_shape: no compile) of each model
    family at the worker's tiny sizes."""
    base = dict(W.KW, fps=1, log_grad_csv=False)
    base.pop("device")
    audio = jnp.zeros((2,) + W.SPEC + (1,))
    visual = jnp.zeros((2, 1, W.HW, W.HW, 3))
    swin_a, swin_v = jnp.zeros((2, 32, 32, 1)), jnp.zeros((2, 1, 32, 32, 3))
    image = jnp.zeros((2, 64, 64, 3))
    out = {}

    def shapes(name, model, *inputs, **kw):
        out[name] = jax.eval_shape(lambda k: model.init(
            {"params": k, "drop": k, "dropout": k, "pe": k}, *inputs,
            train=False, **kw), jax.random.PRNGKey(0))["params"]

    for fusion in ("concat", "sum", "film", "gated"):
        cfg = JaxConfig(**dict(base, fusion_method=fusion))
        shapes(f"dgl-{fusion}", jax_classifier.AVClassifierDGL(config=cfg),
               audio, visual)
        shapes(f"joint-{fusion}", jax_classifier.AVClassifier(config=cfg),
               audio, visual)
    for modality in ("audio", "visual"):
        cfg = JaxConfig(**dict(base, modality=modality))
        shapes(f"dgl-{modality}", jax_classifier.AVClassifierDGL(config=cfg),
               audio, visual)
    swin = JaxConfig(**dict(base, **W.SWIN_TINY))
    shapes("swin-dgl", jax_classifier.AVClassifierSwinDGL(config=swin),
           swin_a, swin_v)
    shapes("swin-joint", jax_classifier.AVClassifierSwin(config=swin),
           swin_a, swin_v)
    shapes("mmformer_n", jax_inter.MMFormerN(**W.MMF), image, image,
           av_inputs=False)
    shapes("mmtm", jax_inter.MMTMNet(num_classes=W.N_CLASSES, width=8),
           image, image, av_inputs=False)
    shapes("sefusion", jax_inter.SEFusionNet(num_classes=W.N_CLASSES,
                                             width=8), image, image)
    shapes("mmformer", jax_inter.MMFormer(**W.MMF), image, image, image)
    return out


def test_row_parallel_rule_matches_gdl_tpu_param_spec(runs):
    """For every model family, the port's parameters that
    `is_row_parallel(name, shape, 2)` names, and the layers that
    `convert_row_parallel` swaps on the ranks, are exactly the leaves for
    which gdl_tpu's `_param_spec(path, leaf, 2)` is P('model', None),
    their flax paths mapped to torch names by the weight bridge. No leaf
    of gdl_tpu's set is left whole (`token_fuse` and the MMTM / SE-fusion
    denses are outside the rule in both); the SE blocks' `fc2`, under no
    `ffn` or `mlp`, stays whole."""
    converted = runs["ranks"]["converted"]
    assert all(c == converted[0] for c in converted[1:])
    port_models = MPW.family_models(port_classifier, port_inter)
    for name, params in _jax_families().items():
        want = set()

        def visit(path, leaf):
            if _param_spec(path, leaf, 2) == P("model", None):
                keys = [p.key for p in path]
                assert keys[-1] == "kernel", keys
                want.add(".".join(_torch_components(keys[:-1])
                                  + ["weight"]))
            return leaf

        jax.tree_util.tree_map_with_path(visit, params)
        model = port_models[name]
        got = {n for n, p in model.named_parameters()
               if is_row_parallel(n, p.shape, 2)}
        assert got == want, name
        assert {n + ".weight" for n in converted[0][name]} == want, name
    se_fc2 = [n for n, p in port_models["sefusion"].named_parameters()
              if n.endswith("fc2.weight")]
    assert se_fc2 and not any(is_row_parallel(
        n, port_models["sefusion"].get_parameter(n).shape, 2)
        for n in se_fc2)
    assert not is_row_parallel("fusion_module.fc_out.weight", (6, 128), 1)
    assert not is_row_parallel("fusion_module.fc_out.weight", (6, 127), 2)
    assert not is_row_parallel("fusion_module.fc_out.bias", (6,), 2)


def test_checkpoints_under_mp_are_whole_and_resume(runs, tmp_path,
                                                   two_threads):
    """Rank 0 writes the resume state and the best checkpoint whole under
    --dp 2 --mp 2 (the keys and shapes of a one-process run's, the
    optimizer's momentum whole): loaded into one process they equal the
    one-process run after the same epoch; the run resumed from the
    resume state on the four ranks ends at the uninterrupted run's whole
    weights and generator, bit for bit."""
    from gdl_tpu_torch.models.classifier import AVClassifierDGL

    results = runs["ranks"]["resume"]
    full = runs["ranks"]["sync"][0]
    for r in results:
        assert [e for e, *_ in r["rest"]] == [1]
        for k, v in full["state"].items():
            assert torch.equal(r["state"][k], v), k
        assert torch.equal(r["gen"], full["gen"])
    assert [a for *_, a in results[0]["rest"]] == [
        a for *_, a in full["log"]][1:]

    one = W.flagship(str(tmp_path / "one"), runs["init"], epochs=1,
                     save_every=1)
    cfg = Config(**dict(W.KW, ckpt_path=str(tmp_path / "c"),
                        log_grad_csv=False))
    model = AVClassifierDGL(cfg)
    optimizer = make_optimizer(cfg, model.parameters(), 4)
    epoch, extra = load_train_state(results[0]["resume_state"], model,
                                    optimizer)
    assert epoch == 1 and extra["step_in_epoch"] == 0
    assert optimizer.steps == 4
    _close_states({k: v for k, v in model.state_dict().items()},
                  one["state"])
    saved = torch.load(results[0]["resume_state"], weights_only=False)
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = list(model.parameters())
    for i, st in saved["optimizer"]["state"].items():
        assert st["momentum_buffer"].shape == params[i].shape
    best = load_best_checkpoint(results[0]["best"])
    fresh = AVClassifierDGL(cfg)
    fresh.load_state_dict(best, strict=True)
    _close_states({k: v for k, v in fresh.state_dict().items()},
                  one["state"])


def test_checks_under_four_ranks(runs):
    """--dp 3 with --mp 2 raises naming WORLD_SIZE 4 and --mp 2; --mp 3
    raises naming --mp; a global batch of 3 cannot split over the two
    data indices and raises gdl_tpu's message."""
    for r in runs["ranks"]["refusals"]:
        assert r["dp3"].startswith("ValueError")
        assert "WORLD_SIZE 4 over --mp 2" in r["dp3"]
        assert r["mp3"].startswith("ValueError") and "--mp 3" in r["mp3"]
        assert "batch_size 3 must divide" in r["batch3"]
