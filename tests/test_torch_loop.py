"""The port's training loop (`gdl_tpu_torch/train/loop.py`) end to end
against `gdl_tpu.train.loop.run_training`: two epochs over the same
pre-tensorized batches (raw_batches=False) from the same initial
weights, then the checkpoint files and resume.

Tolerances: epoch-mean losses and per-step gradient probes rtol 5e-4
(eight steps of drift through BatchNorm at batch 4), accuracies exact
(discrete counts), parameters 5e-4 after the two epochs."""

import csv
import glob
import os

import jax
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu.train import loop as jax_loop
from gdl_tpu.train.dgl import create_train_state
from gdl_tpu.train.optim import make_optimizer as jax_make_optimizer
from gdl_tpu.utils.torch_interop import (
    flax_to_torch_state_dict,
    is_torch_checkpoint,
    load_torch_checkpoint,
    restore_torch_into_state,
)
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.serve import load_from_checkpoint
from gdl_tpu_torch.train.loop import (
    build_harness,
    check_supported,
    run_eval,
    run_training,
)
from gdl_tpu_torch.utils.checkpoint import (
    legacy_checkpoint_name,
    load_best_checkpoint,
    load_train_state,
)
from gdl_tpu_torch.utils.interop import state_dict_from_flax
from gdl_tpu_torch.utils.preempt import PreemptionGuard

N_CLASSES = 6
SPEC, HW, FRAMES = (33, 40), 32, 2
KW = dict(dataset="CREMAD", modulation="Normal", fusion_method="concat",
          alpha=4.0, learning_rate=2e-3, lr_decay_step=[2], batch_size=4,
          epochs=2, num_workers=2, encoder_width=8,
          encoder_stages=[1, 1, 1, 1], fps=FRAMES, log_grad_csv=True,
          eval_drop_last=False, preempt_save=0, random_seed=3)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The models here are tiny: more intra-op threads only spin, and
    under a parallel test run they starve the other workers. Restored
    after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _PreTensorSet:
    """In-memory preprocessed dataset: per-sample dicts matching the
    raw_batches=False step contract. Class-templated so training moves
    accuracy."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        ta = rng.standard_normal((N_CLASSES,) + SPEC + (1,))
        tv = rng.standard_normal((N_CLASSES, FRAMES, HW, HW, 3))
        self.label = rng.integers(0, N_CLASSES, n)
        self.audio = (0.8 * ta[self.label] + rng.standard_normal(
            (n,) + SPEC + (1,))).astype(np.float32)
        self.visual = (0.8 * tv[self.label] + rng.standard_normal(
            (n, FRAMES, HW, HW, 3))).astype(np.float32)

    def __len__(self):
        return len(self.label)

    def __getitem__(self, i):
        return {"audio": self.audio[i], "visual": self.visual[i],
                "label": np.int32(self.label[i])}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_initial_state(cfg):
    """The state gdl_tpu's build_harness starts from (the seed's key)."""
    jmodel = JaxDGL(config=cfg)
    state = create_train_state(jmodel, cfg,
                               jax.random.PRNGKey(cfg.random_seed),
                               jax_make_optimizer(cfg, 4), frames=FRAMES)
    return jmodel, state


def _port_model(cfg, state):
    model = AVClassifierDGL(cfg)
    model.load_state_dict(state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)), strict=True)
    return model


def _rows(path):
    with open(path) as f:
        return [[float(x) for x in row] for row in csv.reader(f)]


def test_two_epochs_match_gdl_tpu_run_training(tmp_path, monkeypatch):
    train_set, test_set = _PreTensorSet(16, 0), _PreTensorSet(10, 1)
    runs = {}
    for name in ("jax", "port"):
        cwd = tmp_path / name
        os.makedirs(cwd)
        monkeypatch.chdir(cwd)
        kw = dict(KW, ckpt_path=str(cwd / "ckpt"))
        log = []

        def callback(epoch, means, acc, lr, state, log=log):
            log.append((epoch, dict(means), acc, lr))

        if name == "jax":
            cfg = JaxConfig(**kw, dp=1, save_torch=True)
            jmodel, state0 = _jax_initial_state(cfg)
            best = jax_loop.run_training(cfg, jmodel, train_set, test_set,
                                         raw_batches=False,
                                         epoch_callback=callback)
        else:
            cfg = Config(**kw, device="cpu")
            model = _port_model(cfg, state0)
            best = run_training(cfg, model, train_set, test_set,
                                raw_batches=False, epoch_callback=callback)
        runs[name] = dict(cwd=cwd, log=log, best=best, cfg=cfg)

    j, p = runs["jax"], runs["port"]
    assert len(p["log"]) == len(j["log"]) == 2
    for (je, jm, jacc, jlr), (pe, pm, pacc, plr) in zip(j["log"], p["log"]):
        assert je == pe and jlr == pytest.approx(plr, rel=1e-9)
        assert pm["steps"] == jm["steps"] == 4
        for k in ("loss", "loss_f", "loss_a", "loss_v", "grad_norm",
                  "audio_grad_sum", "visual_grad_sum", "abs_out_a",
                  "abs_out_v"):
            assert pm[k] == pytest.approx(jm[k], rel=5e-4), (pe, k)
        assert pacc == pytest.approx(jacc, abs=1e-12)  # discrete counts
    assert p["best"] == pytest.approx(j["best"], abs=1e-12)

    # accuracy CSV: sentinel row + one row per epoch; grad CSV: one row
    # per step
    jr = _rows(j["cwd"] / "ckpt" / "CREMAD_full.csv")
    pr = _rows(p["cwd"] / "ckpt" / "CREMAD_full.csv")
    assert pr[0] == [1000, 1000, 1000] and len(pr) == 3
    np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-12)
    jg = _rows(j["cwd"] / "audio_visual_grad_vanilla.csv")
    pg = _rows(p["cwd"] / "audio_visual_grad_vanilla.csv")
    assert len(pg) == len(jg) == 8
    np.testing.assert_allclose(pg, jg, rtol=5e-4)

    # best checkpoint: only after epoch 0, under the legacy name
    jp = sorted(os.path.basename(f) for f in glob.glob(
        str(j["cwd"] / "ckpt" / "*.pth")))
    pp = sorted(os.path.basename(f) for f in glob.glob(
        str(p["cwd"] / "ckpt" / "best_model*.pth")))
    assert pp == jp
    if p["best"] > 0:
        assert pp == [legacy_checkpoint_name(p["cfg"], 1, p["best"])]
        assert "_epoch_1_acc_" in pp[0]
        a = load_best_checkpoint(str(p["cwd"] / "ckpt" / pp[0]), p["cfg"])
        b = load_best_checkpoint(str(j["cwd"] / "ckpt" / jp[0]), p["cfg"])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(), rtol=0,
                                       atol=5e-4, err_msg=k)


@pytest.fixture
def trained(tmp_path, monkeypatch):
    """Three epochs of the port alone, straight through."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**dict(KW, epochs=3, log_grad_csv=False,
                        ckpt_path=str(tmp_path / "ckpt")), device="cpu")
    model = AVClassifierDGL(cfg, generator=torch.Generator().manual_seed(0))
    sets = _PreTensorSet(16, 0), _PreTensorSet(10, 1)
    accs = []
    best = run_training(cfg, model, *sets, raw_batches=False,
                        epoch_callback=lambda **kw: accs.append(kw["acc"]))
    return cfg, model, sets, accs, best, tmp_path


def test_pth_round_trips_through_gdl_tpu_and_serves(trained):
    """The best `.pth` the loop wrote has the reference schema, loads
    into gdl_tpu (load_torch_checkpoint → restore_torch_into_state,
    strict) and back (flax_to_torch_state_dict) to the same tensors;
    run_eval and serve.load_from_checkpoint(backbone='resnet') read it;
    a checkpoint of another modulation and a msgpack file are refused."""
    cfg, model, sets, accs, best, tmp = trained
    files = glob.glob(str(tmp / "ckpt" / "best_model*.pth"))
    if not files:  # accuracy never improved after epoch 0: write one
        from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

        files = [save_best_checkpoint(cfg, model, 2, accs[-1][0])]
    path = sorted(files)[-1]
    assert is_torch_checkpoint(path)
    saved = torch.load(path, weights_only=False)
    assert sorted(saved) == ["acc", "alpha", "fusion", "model",
                             "modulation", "optimizer", "saved_epoch",
                             "scheduler"]
    assert saved["modulation"] == "Normal" and saved["fusion"] == "concat"
    assert saved["scheduler"] == {"milestones": [2], "gamma": 0.1}
    assert saved["optimizer"]["param_groups"][0]["momentum"] == 0.9

    jcfg = JaxConfig(**dict(KW, epochs=3, log_grad_csv=False), dp=1)
    _, state = _jax_initial_state(jcfg)
    loaded = load_torch_checkpoint(path, jcfg)
    state = restore_torch_into_state(state, loaded, strict=True)
    back = flax_to_torch_state_dict(_np_tree(state.params),
                                    _np_tree(state.batch_stats), prefix="")
    for k, v in saved["model"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(),
                                      err_msg=k)

    # the port's own eval entry points read the file
    fresh = AVClassifierDGL(cfg, generator=torch.Generator().manual_seed(9))
    acc = run_eval(cfg, fresh, sets[1], path, raw_batches=False)
    epoch = saved["saved_epoch"]
    assert acc == pytest.approx(accs[epoch], abs=1e-12)
    served = load_from_checkpoint(cfg, path, device="cpu")
    for k, v in served.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k

    with pytest.raises(AssertionError, match="modulation"):
        run_eval(Config(**dict(KW, modulation="OGM"), device="cpu"),
                 fresh, sets[1], path, raw_batches=False)
    bogus = tmp / "legacy.msgpack"
    bogus.write_bytes(b"\x88\xa5model")
    with pytest.raises(ValueError, match="msgpack"):
        load_best_checkpoint(str(bogus), cfg)
    with pytest.raises(ValueError, match="msgpack"):
        load_train_state(str(bogus), fresh, None)


def test_preempt_then_resume_reaches_the_same_parameters(trained):
    """A run stopped by the guard mid-epoch 1 (step 2 of 4) writes
    resume_state.pth and stops before eval; --resume replays the rest of
    that epoch and the next, to the SAME parameters, momentum buffers,
    running statistics, accuracies and best accuracy as the
    uninterrupted run; --save_every writes an epoch-boundary state."""
    cfg, model, sets, accs, best, tmp = trained
    ckpt2 = str(tmp / "ckpt2")
    cfg2 = Config(**dict(KW, epochs=3, log_grad_csv=False, ckpt_path=ckpt2,
                         save_every=1), device="cpu")

    class _MidEpochGuard(PreemptionGuard):
        calls = 0

        def should_stop(self, step_count):
            _MidEpochGuard.calls += 1
            if _MidEpochGuard.calls == 6:  # epoch 1, step 2
                self.trigger()
            return self.triggered()

    first = []
    m2 = AVClassifierDGL(cfg2, generator=torch.Generator().manual_seed(0))
    run_training(cfg2, m2, *sets, raw_batches=False,
                 epoch_callback=lambda **kw: first.append(kw["acc"]),
                 preempt_guard=_MidEpochGuard())
    assert len(first) == 1  # epoch 0 evaluated, epoch 1 stopped before eval
    resume_path = os.path.join(ckpt2, "resume_state.pth")
    state = torch.load(resume_path, weights_only=False)
    assert state["epoch"] == 1 and state["extra"]["step_in_epoch"] == 2
    assert state["optimizer_steps"] == 6
    assert set(state["extra"]["partial_sums"]) >= {"loss", "loss_f"}

    rest = []
    cfg3 = Config(**dict(KW, epochs=3, log_grad_csv=False, ckpt_path=ckpt2,
                         resume=resume_path), device="cpu")
    m3 = AVClassifierDGL(cfg3, generator=torch.Generator().manual_seed(7))
    best3 = run_training(cfg3, m3, *sets, raw_batches=False,
                         epoch_callback=lambda **kw: rest.append(
                             (kw["epoch"], kw["acc"], kw["means"],
                              kw["state"])))
    assert [e for e, *_ in rest] == [1, 2]
    assert [a for _, a, *_ in rest] == accs[1:]
    assert rest[0][2]["steps"] == 2  # the tail of the interrupted epoch
    for (k, v), (k3, v3) in zip(model.state_dict().items(),
                                m3.state_dict().items()):
        assert k == k3 and torch.equal(v, v3), k
    h3 = rest[-1][3]
    assert h3.optimizer.steps == 12
    # best accuracy counts only the epochs this process evaluated
    assert best3 == pytest.approx(max(a[0] for a in accs[1:]), abs=1e-12)


def test_unported_options_raise_by_name():
    """Every option the CLI accepts and the port does not implement
    raises NotImplementedError naming it (the DGL and joint lineages take
    the same options); --sync_bn 0 --dp 2 and --mp 2 without torchrun's
    process group raise, naming torchrun; CUDA without a card raises.
    --use_tensorboard, the AdaGrad / Adam optimizers, --pretrained_path
    (loaded when the harness is built, tests/test_torch_pretrained.py)
    and --profile_dir (tests/test_torch_profiling.py) are ported and
    pass; main_intermediate alone refuses --profile_dir, naming the reason
    (gdl_tpu's main_intermediate.py traces nothing)."""
    from gdl_tpu_torch.main_intermediate import check_no_trace

    base = dict(KW, device="cpu")
    with pytest.raises(NotImplementedError, match="torchrun"):
        check_supported(Config(**dict(base, sync_bn=False, dp=2)))
    with pytest.raises(NotImplementedError, match="--mp 2.*torchrun"):
        check_supported(Config(**dict(base, mp=2)))
    for kw in (dict(use_tensorboard=True), dict(optimizer="Adam"),
               dict(optimizer="AdaGrad"), dict(pretrained_path="x.pth"),
               dict(profile_dir="/tmp/p")):
        check_supported(Config(**dict(base, **kw)))
    with pytest.raises(NotImplementedError,
                       match="profile_dir.*own epoch loop"):
        check_no_trace(Config(**dict(base, profile_dir="/tmp/p")))
    check_no_trace(Config(**base))
    with pytest.raises(ValueError, match="compute_dtype"):
        check_supported(Config(**dict(base, compute_dtype="float16")))
    if not torch.cuda.is_available():
        cfg = Config(**KW)  # device defaults to "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_harness(cfg, AVClassifierDGL(cfg), 4)


def test_init_parallel_and_the_loaders_need_the_grid():
    """Without a process group `init_parallel` resolves --dp -1 to this one
    process and builds no grid; --mp 2 raises naming torchrun. The
    loaders refuse a cfg.mp whose grid was not built (they would stride
    by the rank instead of the data index)."""
    from gdl_tpu_torch.parallel.distributed import init_parallel
    from gdl_tpu_torch.parallel.mesh import data_size, model_size
    from gdl_tpu_torch.train.loop import make_loaders

    cfg = Config(**dict(KW, device="cpu", dp=-1))
    init_parallel(cfg)
    assert (cfg.dp, data_size(), model_size()) == (1, 1, 1)
    with pytest.raises(NotImplementedError, match="--mp 2.*torchrun"):
        init_parallel(Config(**dict(KW, device="cpu", mp=2)))
    with pytest.raises(RuntimeError, match="--mp 2.*init_parallel"):
        make_loaders(Config(**dict(KW, device="cpu", mp=2)), None, [])
