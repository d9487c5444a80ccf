"""Multi-process data parallelism of the port (`gdl_tpu_torch/parallel/`)
over two gloo ranks on the CPU, against the port's one-process run of the
global batch and against gdl_tpu's `--dp 2` program.

The two ranks run every scenario of `tests/torch_dist_worker.py` once
(one process group, batch 4 global, 2 a rank); the test process runs the
one-process references and the two gdl_tpu references (jitted, from one
initial state handed to gdl_tpu's loop in place of its eager init).

Tolerances: two ranks against one process, parameters, BN buffers and
epoch means rtol 2e-5 (the sums over the batch run in another order),
accuracies and generator states exact; against gdl_tpu, test_torch_loop's
bars (5e-4); the global-statistics BN against nn.BatchNorm2d on the
concatenated batch 1e-6; the dropout offsets bit for bit."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

import gdl_tpu.train.loop as jax_loop
from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu.train.dgl import TrainState
from gdl_tpu_torch.ops.dropout import (
    philox_keep_mask,
    philox_u32,
    prng_dropout_mask,
    prng_dropout_mask_ref,
)
from gdl_tpu_torch.ops.self_attention import (
    make_dropout,
    self_attention_fused_bwd,
    self_attention_fused_fwd,
    self_attention_qkv_fwd,
)
from gdl_tpu_torch.utils.interop import state_dict_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
RTOL = 2e-5
JAX_RTOL = 5e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out_dir, init_path, world=2, timeout=400):
    """Every scenario on `world` gloo ranks → {scenario: [result per
    rank]}."""
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out_dir, init_path],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    logs = [open(os.path.join(out_dir, f"rank{r}.log")).read()
            for r in range(world)]
    assert codes == [0] * world, "\n".join(logs)[-6000:]
    names = sorted({f.rsplit("_rank", 1)[0] for f in os.listdir(out_dir)
                    if f.endswith(".pt")})
    return {n: [torch.load(os.path.join(out_dir, f"{n}_rank{r}.pt"),
                           weights_only=False) for r in range(world)]
            for n in names}


def _jax_cfg(**kw):
    kw = dict(W.KW, **kw)
    kw.pop("device")
    return JaxConfig(**kw, save_torch=True)


def _jax_init(cfg):
    """gdl_tpu's initial params and stats for the flagship, jitted."""
    model = JaxDGL(config=cfg)
    audio = np.zeros((2,) + W.SPEC + (1,), np.float32)
    visual = np.zeros((2, W.FRAMES, W.HW, W.HW, 3), np.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k}, audio, visual, train=False))(
            jax.random.PRNGKey(cfg.random_seed))
    return jax.device_get(variables["params"]), jax.device_get(
        variables["batch_stats"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, and the flagship's initial weights (those
    of gdl_tpu's init)."""
    out = tmp_path_factory.mktemp("ranks")
    params, stats = _jax_init(_jax_cfg())
    init = state_dict_from_flax(params, stats)
    init_path = str(out / "init.pth")
    torch.save(init, init_path)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = _launch(str(out), init_path)
    finally:
        torch.set_num_threads(before)
    return dict(ranks=ranks, init=init, params=params, stats=stats)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close_states(got, want, rtol=RTOL, atol=1e-6):
    """gdl_tpu keeps no BN step count (its state dicts carry 0)."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("num_batches_tracked"):
            assert int(want[k]) in (0, int(got[k])), k
            continue
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _equal_across_ranks(results, keys=("gen",)):
    a, b = results
    for k in keys:
        assert torch.equal(a[k], b[k]), k
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


def _close_logs(got, want):
    assert len(got) == len(want)
    for (ge, gm, gacc), (we, wm, wacc) in zip(got, want):
        assert ge == we and gm["steps"] == wm["steps"]
        for k, v in wm.items():
            if k in ("steps", "wall_time", "preempted"):
                continue
            assert gm[k] == pytest.approx(v, rel=RTOL, abs=1e-7), (ge, k)
        assert tuple(gacc) == tuple(wacc)


def _jax_run(runs, tmp_path, monkeypatch, **kw):
    """gdl_tpu.train.loop.run_training with --dp 2 from the fixture's
    initial state → (epoch log, torch state dict of the end)."""
    params, stats = runs["params"], runs["stats"]

    def fed_state(model, cfg, rng, optimizer, **_):
        return TrainState(step=np.zeros((), np.int32), params=params,
                          batch_stats=stats, opt_state=optimizer.init(params))

    monkeypatch.setattr(jax_loop, "create_train_state", fed_state)
    os.makedirs(tmp_path)
    monkeypatch.chdir(tmp_path)
    cfg = _jax_cfg(ckpt_path=str(tmp_path / "ckpt"), dp=2, **kw)
    log, box = [], {}

    def callback(epoch, means, acc, lr, state):
        log.append((epoch, dict(means), acc))
        box["h"] = state

    jax_loop.run_training(cfg, JaxDGL(config=cfg), W.PreTensorSet(16, 0),
                          W.PreTensorSet(8, 1), raw_batches=False,
                          epoch_callback=callback)
    state = box["h"]
    return log, state_dict_from_flax(
        jax.tree.map(np.asarray, jax.device_get(state.params)),
        jax.tree.map(np.asarray, jax.device_get(state.batch_stats)))


def test_flagship_sync_bn_two_ranks_match_one_process_and_gdl_tpu(
        runs, tmp_path, monkeypatch, one_thread):
    """Two epochs of the flagship DGL run with global BatchNorm over two
    ranks: the ranks agree bit for bit (weights, generator, accuracy),
    equal the one-process run of the global batch and gdl_tpu's --dp 2
    program; only rank 0 writes files."""
    r0, r1 = runs["ranks"]["sync"]
    _equal_across_ranks((r0, r1))
    assert [acc for *_, acc in r0["log"]] == [acc for *_, acc in r1["log"]]
    assert r1["files"] == []
    assert {"ckpt/CREMAD_full.csv",
            "audio_visual_grad_vanilla.csv"} <= set(r0["files"])

    one = W.flagship(str(tmp_path / "one"), runs["init"])
    _close_states(r0["state"], one["state"])
    _close_logs(r0["log"], one["log"])
    assert torch.equal(r0["gen"], one["gen"])

    jlog, jstate = _jax_run(runs, tmp_path / "jax", monkeypatch)
    for (_, pm, pacc), (_, jm, jacc) in zip(r0["log"], jlog):
        for k in ("loss", "loss_f", "loss_a", "loss_v", "grad_norm"):
            assert pm[k] == pytest.approx(float(jm[k]), rel=JAX_RTOL), k
        assert tuple(pacc) == pytest.approx(tuple(jacc), abs=1e-12)
    _close_states(r0["state"], jstate, rtol=0, atol=JAX_RTOL)


def test_flagship_per_replica_bn_matches_gdl_tpu_grouped_bn(
        runs, tmp_path, monkeypatch, one_thread):
    """--sync_bn 0 over two ranks: each rank normalises its own rows
    (gdl_tpu's GroupedBatchNorm with two groups); after two epochs the
    parameters match gdl_tpu's --dp 2 --sync_bn 0 run and the running
    statistics, the same on both ranks, are rank 0's (replica 0's)."""
    r0, r1 = runs["ranks"]["nosync"]
    _equal_across_ranks((r0, r1))
    jlog, jstate = _jax_run(runs, tmp_path / "jax", monkeypatch,
                            sync_bn=False)
    _close_states(r0["state"], jstate, rtol=0, atol=JAX_RTOL)
    for (_, pm, pacc), (_, jm, jacc) in zip(r0["log"], jlog):
        assert pm["loss"] == pytest.approx(float(jm["loss"]), rel=JAX_RTOL)
        assert tuple(pacc) == pytest.approx(tuple(jacc), abs=1e-12)


@pytest.mark.parametrize("scenario", ["augmented", "joint", "swin",
                                      "mmformer", "mmformer_batched"])
def test_random_draws_are_rank_invariant(runs, scenario, tmp_path,
                                         one_thread):
    """Every draw with a batch dimension is made at the global batch and
    each rank keeps its rows: with augmentation on (crop and flip), the
    joint lineage's PE noise, modality drop and OGM-GE noise, a tiny
    Swin's DropPath and a tiny mmformer_n's dropout masks (through their
    place in the stream; under --batched_inter 1 three segments of it),
    two ranks reach the one-process run's parameters, and the generator
    states are equal on every rank and to the one process's. The joint
    run's OGM-GE coefficients are the global batch's."""
    r0, r1 = runs["ranks"][scenario]
    _equal_across_ranks((r0, r1))
    fn = getattr(W, scenario)
    one = (fn() if scenario.startswith("mmformer")
           else fn(str(tmp_path / "one")))
    _close_states(r0["state"], one["state"])
    assert torch.equal(r0["gen"], one["gen"])
    if scenario == "joint":
        assert r0["coeffs"] == r1["coeffs"]
        np.testing.assert_allclose(r0["coeffs"], one["coeffs"], rtol=RTOL)
        assert any(c != 1.0 for step in one["coeffs"] for c in step)
    if scenario.startswith("mmformer"):
        np.testing.assert_allclose(r0["losses"], one["losses"], rtol=RTOL)
    else:
        _close_logs(r0["log"], one["log"])


def test_preemption_on_one_rank_stops_both_and_resumes(runs):
    """A flag raised on rank 1 alone (after its first step, agreement
    every 2 steps) stops both ranks after step 2 of epoch 0, before eval;
    rank 0 writes one resume state, and the run resumed from it on both
    ranks ends at the uninterrupted run's weights and generator, bit for
    bit."""
    r0, r1 = runs["ranks"]["preempt"]
    for r in (r0, r1):
        assert r["first"] == []  # stopped before epoch 0's eval
        assert r["step_in_epoch"] == 2 and r["resume_epoch"] == 0
        assert [e for e, *_ in r["rest"]] == [0, 1]
    _equal_across_ranks((r0, r1))
    full = runs["ranks"]["sync"][0]
    for k, v in full["state"].items():
        assert torch.equal(r0["state"][k], v), k
    assert torch.equal(r0["gen"], full["gen"])
    assert [a for *_, a in r0["rest"]] == [a for *_, a in full["log"]]


def test_global_batch_norm_equals_batch_norm_of_the_whole_batch(runs):
    """GlobalBatchNorm2d over two ranks (two training steps): each rank's
    output and input gradient are its rows of nn.BatchNorm2d's on the
    concatenated batch, the parameter gradients summed over the ranks are
    its, and the running statistics (torch's unbiased variance over the
    global count) are its on both ranks."""
    x, g = W.bn_inputs()
    ref = nn.BatchNorm2d(3, eps=1e-5, momentum=0.1)
    ranks = runs["ranks"]["bn"]
    for step in range(2):
        xs = (x * (step + 1)).requires_grad_(True)
        y = ref(xs)
        (y * g).sum().backward()
        got = [r["steps"][step] for r in ranks]
        for name, want in (("y", y.detach()), ("dx", xs.grad)):
            np.testing.assert_allclose(
                torch.cat([s[name] for s in got]).numpy(), want.numpy(),
                rtol=0, atol=1e-6, err_msg=name)
        for name, want in (("dw", ref.weight.grad), ("db", ref.bias.grad)):
            np.testing.assert_allclose(
                sum(s[name] for s in got).numpy(), want.numpy(), rtol=0,
                atol=1e-5, err_msg=name)
        ref.weight.grad = ref.bias.grad = None
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"].numpy(),
                                   ref.running_mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["running_var"].numpy(),
                                   ref.running_var.numpy(), atol=1e-6)
        assert r["tracked"] == 2


def test_checks_under_a_process_group(runs):
    """Under two ranks, --dp 3 raises naming torchrun's WORLD_SIZE,
    --eval_drop_last 0 raises naming the flag, and --sync_bn 0 with --dp
    -1 unresolved (per-rank BN groups unknown to the model) raises naming
    --dp 2."""
    for r in runs["ranks"]["refusals"]:
        assert r["dp3"].startswith("ValueError") and "WORLD_SIZE 2" in r["dp3"]
        assert "--eval_drop_last 1" in r["drop_last"]
        assert "--sync_bn 0" in r["unresolved_dp"]
        assert "--dp 2" in r["unresolved_dp"]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_offset_is_a_slice_of_the_global_mask(rate):
    """The mask generator's plain versions at an element offset (a
    multiple of 4) are, bit for bit, that slice of the mask drawn from 0:
    a rank's rows of the global batch's mask. Offsets that are not whole
    Philox groups are refused."""
    words = torch.tensor([12345, -678], dtype=torch.int32)
    shape, rows = (4, 3, 5, 6), 2
    whole = philox_keep_mask(words, shape, rate)
    per_rank = 3 * 5 * 6 * rows
    for r in range(2):
        part = philox_keep_mask(words, (rows,) + shape[1:], rate,
                                r * per_rank)
        assert torch.equal(part, whole[r * rows:(r + 1) * rows])
        assert torch.equal(
            prng_dropout_mask_ref(words, (rows,) + shape[1:], rate,
                                  torch.bfloat16, r * per_rank),
            prng_dropout_mask_ref(words, shape, rate,
                                  torch.bfloat16)[r * rows:(r + 1) * rows])
        assert torch.equal(
            prng_dropout_mask(words, (rows,) + shape[1:], rate,
                              offset=r * per_rank),
            prng_dropout_mask(words, shape, rate)[r * rows:(r + 1) * rows])
    assert torch.equal(philox_u32(words, 10, 8), philox_u32(words, 18)[8:])
    with pytest.raises(ValueError, match="multiple of 4"):
        philox_u32(words, 8, 2)


def test_attention_dropout_offset_is_a_slice_of_the_global_mask():
    """The fused self-attention's plain versions with 'kernel' dropout at
    an element offset compute, on a rank's rows, the rows of the global
    batch's forward and backward, and draw its rows of the keep mask; so
    does the forward on a given qkv (#12's, which draws its mask in the
    kernel as #10 does)."""
    rng = np.random.default_rng(3)
    b, n, c, heads = 4, 6, 16, 2
    x = torch.from_numpy(rng.standard_normal((b, n, c))).float()
    w = torch.from_numpy(rng.standard_normal((3 * c, c)) * 0.2).float()
    g = torch.from_numpy(rng.standard_normal((b, n, c))).float()
    words = torch.tensor([7, 99], dtype=torch.int32)
    drop = make_dropout(x, heads, 0.3, True, "kernel", words)
    out, qkv, p, keep = self_attention_fused_fwd(x, w, heads, drop=drop,
                                                 return_keep=True)
    dqkv = self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
    rows = b // 2
    for r in range(2):
        sl = slice(r * rows, (r + 1) * rows)
        d = make_dropout(x[sl], heads, 0.3, True, "kernel", words,
                         offset=r * rows * heads * n * n)
        o, q, pp, k = self_attention_fused_fwd(x[sl], w, heads, drop=d,
                                               return_keep=True)
        assert torch.equal(k, keep[sl])
        np.testing.assert_allclose(o.numpy(), out[sl].numpy(), atol=1e-6)
        np.testing.assert_allclose(
            self_attention_fused_bwd(q, pp, g[sl], heads, drop=d).numpy(),
            dqkv[sl].numpy(), atol=1e-6)
        o12, p12, k12 = self_attention_qkv_fwd(q, heads, drop=d,
                                               return_keep=True)
        assert torch.equal(k12, keep[sl]) and torch.equal(p12, pp)
        np.testing.assert_allclose(o12.numpy(), out[sl].numpy(), atol=1e-6)


def _stack_rows(world, rank, b, passes=3):
    """Rank `rank`'s rows of a [passes·world·b] stack of `passes` global
    batches: pass p's rows p·B + rank·b .. + b − 1 (B = world·b)."""
    big = world * b
    return torch.cat([torch.arange(p * big + rank * b, p * big + rank * b + b)
                      for p in range(passes)])


def test_one_segment_layout_is_the_element_offset(monkeypatch):
    """A layout of one segment (seg_stride == seg_elems, whatever they
    are) draws, bit for bit, what its element offset alone draws: the
    words, #14's plain mask and #10 / #11's plain keep mask. At world size
    1 every `element_layout` is one segment from 0, stacked passes or
    not; with one pass it is the rank's first element."""
    from gdl_tpu_torch.ops.dropout import check_layout
    from gdl_tpu_torch.parallel import distributed as dist
    from gdl_tpu_torch.parallel import mesh

    words = torch.tensor([4242, -31], dtype=torch.int32)
    for off, seg in ((0, 40), (8, 12), (64, 6), (4, 0)):
        assert torch.equal(philox_u32(words, 30, (off, seg, seg)),
                           philox_u32(words, 30, off))
        assert torch.equal(
            prng_dropout_mask(words, (5, 6), 0.3, torch.bfloat16,
                              offset=(off, seg, seg)),
            prng_dropout_mask(words, (5, 6), 0.3, torch.bfloat16,
                              offset=off))
        assert check_layout((off, seg, seg)) == (off, 0, 0)
    x = torch.zeros((2, 4, 8))
    a = make_dropout(x, 2, 0.3, True, "kernel", words, offset=(16, 8, 8))
    z = make_dropout(x, 2, 0.3, True, "kernel", words, offset=16)
    assert torch.equal(a.multiplier((2, 2, 4, 4), torch.float32),
                       z.multiplier((2, 2, 4, 4), torch.float32))
    assert dist.element_layout(96) == (0, 96, 96)
    assert dist.element_layout(96, passes=3) == (0, 32, 32)
    monkeypatch.setattr(mesh, "data_size", lambda: 2)  # data index 1 of 2
    monkeypatch.setattr(mesh, "data_index", lambda: 1)
    assert dist.element_layout(96) == (96, 96, 96)
    assert dist.element_layout(96, passes=3) == (32, 32, 64)
    for bad in ((2, 0, 0), (0, 6, 12), (0, 8, 4), (0, -4, 8)):
        with pytest.raises(ValueError):
            check_layout(bad)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_three_segments_are_a_ranks_rows_of_the_global_stack(rate):
    """--batched_inter 1 stacks three passes' batches: each rank's [3b]
    mask, drawn in the three-segment layout of `element_layout`, is bit
    for bit its rows of the [3B] mask one process draws (#14's plain
    version, at both dtypes), and so are the keep mask of #10 / #11's
    plain versions, their forward and dqkv, and #12's forward."""
    world, b = 2, 2
    words = torch.tensor([987, 65], dtype=torch.int32)
    row = (5, 8)
    per_row = 5 * 8
    whole = prng_dropout_mask_ref(words, (3 * world * b,) + row, rate)
    whole16 = prng_dropout_mask_ref(words, (3 * world * b,) + row, rate,
                                    torch.bfloat16)
    for k in range(world):
        lay = (k * b * per_row, b * per_row, world * b * per_row)
        rows = _stack_rows(world, k, b)
        assert torch.equal(
            prng_dropout_mask(words, (3 * b,) + row, rate, offset=lay),
            whole[rows])
        assert torch.equal(
            prng_dropout_mask_ref(words, (3 * b,) + row, rate,
                                  torch.bfloat16, lay), whole16[rows])
        assert torch.equal(philox_keep_mask(words, (3 * b,) + row, rate, lay),
                           philox_keep_mask(words, (3 * world * b,) + row,
                                            rate)[rows])

    rng = np.random.default_rng(8)
    n, c, heads = 6, 16, 2
    big = 3 * world * b
    x = torch.from_numpy(rng.standard_normal((big, n, c))).float()
    w = torch.from_numpy(rng.standard_normal((3 * c, c)) * 0.2).float()
    g = torch.from_numpy(rng.standard_normal((big, n, c))).float()
    drop = make_dropout(x, heads, rate, True, "kernel", words)
    out, qkv, p, keep = self_attention_fused_fwd(x, w, heads, drop=drop,
                                                 return_keep=True)
    dqkv = self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
    per_row = heads * n * n
    for k in range(world):
        rows = _stack_rows(world, k, b)
        lay = (k * b * per_row, b * per_row, world * b * per_row)
        d = make_dropout(x[rows], heads, rate, True, "kernel", words,
                         offset=lay)
        o, q, pp, kk = self_attention_fused_fwd(x[rows], w, heads, drop=d,
                                                return_keep=True)
        assert torch.equal(kk, keep[rows]) and torch.equal(o, out[rows])
        assert torch.equal(
            self_attention_fused_bwd(q, pp, g[rows], heads, drop=d),
            dqkv[rows])
        o12, p12, k12 = self_attention_qkv_fwd(q, heads, drop=d,
                                               return_keep=True)
        assert torch.equal(k12, keep[rows]) and torch.equal(p12, pp)
        assert torch.equal(o12, out[rows])
