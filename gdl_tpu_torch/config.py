"""Typed configuration with CLI parity to the reference scripts: the
port's own copy of `gdl_tpu/config.py` (nothing of that package is
imported), with the same fields, flags and defaults, so a command line
written for `main_dgl.py` works for `python -m gdl_tpu_torch.main_dgl`.

The reference uses bare argparse in each script (main.py:27-74 — 29 flags,
main_dgl.py:24-65 — 24 flags, valid.py:24-65) plus runtime mutation of the
args namespace. Here a single dataclass carries every documented flag,
and `add_arguments`/`from_args` give the same CLI surface.

One field is the port's own: `device` (`--device`, default "cuda"),
resolved through `serve.resolve_device`, which raises when CUDA is asked
for and absent. `--device cpu` is the one way to ask for the CPU.

Fields of the TPU package that the port parses, keeps and IGNORES (they
select TPU layouts or XLA lowerings that have no counterpart on a GPU):
`gpu_ids`, `swin_window_resident`, `fast_dropout_rng`,
`compilation_cache_dir` (a flag only). The four Swin kernel flags act as
they do in gdl_tpu (`models/classifier.py::AVClassifierSwinDGL`):
`use_pallas_attn` and `use_pallas_attn_eval` choose between the attention
kernels and their plain versions in training and at eval,
`fuse_qkv_gemm 0` takes the qkv projection out of the attention kernel,
`fuse_mlp 1` runs each block's MLP as one kernel. Options that are
accepted and not ported yet raise NotImplementedError where they would
take effect (`train/loop.py::check_supported`): among them `dp` and `mp`
above one device, until the multi-GPU slice (`--dp -1`, all devices, is
the port's one device).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
from typing import List, Optional, Tuple

# Class counts per dataset — reference models/basic_model.py:15-26.
N_CLASSES = {
    "VGGSound": 309,
    "KineticSound": 34,
    "kinect400": 400,
    "CREMAD": 6,
    "AVE": 28,
}

# Audio frontend parameters per dataset — reference dataset/*.py:
#   CREMAD  (dataset/CramedDataset.py:60-66):  22.05 kHz, 3 s, n_fft 512, hop 353
#   KineticSound (dataset/KSDataset.py:139-149): 16 kHz, 5 s, n_fft 256, hop 128
#   VGGSound (dataset/VGGSoundDataset.py:112-122): same as KS
#   AVE (dataset/AVEDataset.py:81-88): 22.05 kHz, 3 s, n_fft 512, hop 256 (+224² resize)
#   kinect400 (dataset/Kinect400.py:120-127): 16 kHz, 8 s, n_fft 256, hop 128
AUDIO_PARAMS = {
    # crop_start_s: upper bound (seconds) of the random crop start —
    # random.randint(0, sr*crop_start_s) in the reference loaders
    # (dataset/KSDataset.py:143, dataset/Kinect400.py:124: 2 s bound with an
    # 8 s crop of the >=10 s tiled waveform).
    "CREMAD": dict(sample_rate=22050, seconds=3, n_fft=512, hop=353),
    "KineticSound": dict(sample_rate=16000, seconds=5, n_fft=256, hop=128,
                         crop_start_s=5),
    "VGGSound": dict(sample_rate=16000, seconds=5, n_fft=256, hop=128,
                     crop_start_s=5),
    "AVE": dict(sample_rate=22050, seconds=3, n_fft=512, hop=256),
    "kinect400": dict(sample_rate=16000, seconds=8, n_fft=256, hop=128,
                      crop_start_s=2),
}


def spectrogram_shape(dataset: str, swin: bool = False) -> Tuple[int, int]:
    """(freq_bins, frames) of the spectrogram fed to the audio encoder.

    center=True STFT: frames = 1 + num_samples // hop; bins = n_fft//2 + 1.
    Swin runs resize the spectrogram to 224x224 (CramedDataset.py:163), and
    AVE does so unconditionally (dataset/AVEDataset.py:88).
    """
    if swin or dataset == "AVE":
        return (224, 224)
    p = AUDIO_PARAMS[dataset]
    n = p["sample_rate"] * p["seconds"]
    return (p["n_fft"] // 2 + 1, 1 + n // p["hop"])


@dataclasses.dataclass
class Config:
    # --- reference CLI flags (main.py:27-74, main_dgl.py:24-65) ---
    dataset: str = "CREMAD"
    modulation: str = "OGM_GE"  # ['Normal', 'OGM', 'OGM_GE']
    fusion_method: str = "concat"  # ['sum', 'concat', 'gated', 'film']
    fps: int = 1
    use_video_frames: int = 3
    num_frame: int = 1
    audio_path: str = "./train_test_data/CREMA-D/AudioWAV"
    visual_path: str = "./train_test_data/CREMA-D"
    preprocessed_path: str = ""  # offline-decoded cache root built by
    # tools/preprocess_dataset.py: resampled waveforms + 256^2 canonical
    # frames as .npy/.npz. When set, the datasets skip wav/JPEG decode
    # and resampling entirely (the host-pipeline bottleneck); per-epoch
    # augmentation (frame selection, audio crop) still runs identically.
    preprocessed_write: bool = False  # populate preprocessed_path ON THE
    # FLY: any live-decoded sample also writes its cache entry (atomic,
    # idempotent — same files tools/preprocess_dataset.py builds), so the
    # first epoch warms the cache and later epochs take the native
    # batched read path. Costs extra first-epoch decode (ALL frames of
    # each clip go onto the canonical canvas, not just the selected ones).
    batch_size: int = 64
    epochs: int = 100
    optimizer: str = "sgd"  # ['sgd', 'AdaGrad', 'Adam']
    learning_rate: float = 0.001
    lr_decay_step: List[int] = dataclasses.field(default_factory=lambda: [70])
    lr_decay_ratio: float = 0.1
    modulation_starts: int = 0
    modulation_ends: int = 50
    alpha: float = 4.0
    ckpt_path: str = "ckpt"
    train: bool = False
    use_tensorboard: bool = False
    tensorboard_path: Optional[str] = None
    random_seed: int = 0
    gpu_ids: str = "1"  # accepted for CLI parity; ignored (see device)
    modality: str = "full"  # ['full', 'audio', 'visual']
    backbone: str = "resnet"  # ['resnet', 'swin']
    total_epoch: int = 10  # warmup length (main.py GradualWarmupScheduler)
    drop: int = 0
    # --- main.py-only flags (main.py:63-72) ---
    pe: int = 0  # probabilistic embedding heads
    max: float = 1e20
    beta: float = 0.0  # KL-regularizer weight
    pretrain: bool = False
    warmup: bool = False
    gamma: float = 1.0
    # --- gdl_tpu's additions ---
    dp: int = -1  # data-parallel mesh size; -1 = all devices
    mp: int = 1  # model-parallel mesh size (fusion/classifier dense kernels)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    fast_dropout_rng: bool = True  # gdl_tpu's choice of PRNG lowering;
    # ignored by the port (torch.Generator draws)
    sync_bn: bool = True  # global-batch BN stats. --sync_bn 0 selects
    # per-replica (DataParallel-semantics) BN, one group per replica; with
    # the port's one device that is one group as well
    strict_compat: bool = False  # replicate reference quirks that affect
    # reported accuracy (first-N frame selection, drop_last test truncation)
    log_grad_csv: bool = True  # per-step encoder grad-magnitude CSV
    # (main_dgl.py:148-152); disable for max throughput
    eval_drop_last: bool = True  # reference test DataLoader drop_last=True
    # (main_dgl.py:287-288) truncates the test set; False evaluates all
    save_torch: bool = False  # write best checkpoints as REAL torch .pth
    # files (the reference's artifact format, loadable by its valid.py)
    # instead of msgpack
    pretrained_path: Optional[str] = None  # local torchvision-format
    # backbone state dict partial-loaded into the encoders at startup
    # (reference resnet18_se.py:228-248 ImageNet partial-load semantics)
    resume: Optional[str] = None  # resume training from a state checkpoint
    save_every: int = 0  # also save a resumable state every N epochs
    preempt_save: int = 1  # catch SIGTERM, checkpoint at the next step
    # boundary (epoch + step_in_epoch), exit cleanly; --resume then replays
    # the remainder of the interrupted epoch exactly (utils/preempt.py)
    preempt_sync_every: int = 32  # multi-host stop-agreement cadence in
    # steps; each check is a blocking allgather (pipeline drain), so raise
    # it for very fast steps. Epoch end always runs an agreement check.
    num_workers: int = 8  # host-side data pipeline threads
    encoder_width: int = 64  # ResNet stem width (64 = reference ResNet-18);
    # smaller values give cheap models for tests/CI
    encoder_stages: Optional[List[int]] = None  # blocks per stage; None =
    # backbone default ((2,2,2,2) for resnet18)
    profile_dir: Optional[str] = None  # capture a profiler trace of a
    # few steady-state steps of the first epoch (not ported yet: raises)
    # Swin hyperparameters (reference Swin-B defaults,
    # swin_transformer.py:513-518); overridable for small configs/tests
    swin_embed_dim: int = 128
    swin_depths: List[int] = dataclasses.field(
        default_factory=lambda: [2, 2, 18, 2])
    swin_heads: List[int] = dataclasses.field(
        default_factory=lambda: [4, 8, 16, 32])
    swin_window: int = 7
    swin_img_size: int = 224
    swin_patch: int = 4
    # gdl_tpu's Swin kernel switches, with its meanings
    # (models/classifier.py::AVClassifierSwinDGL)
    use_pallas_attn: bool = True  # False: plain attention
    fuse_qkv_gemm: bool = True  # False: the qkv projection outside the
    # attention kernel (training)
    fuse_mlp: bool = False  # True: each block's MLP as one kernel
    use_pallas_attn_eval: bool = True  # False: plain attention at eval
    swin_window_resident: bool = True  # a TPU layout: parsed, ignored
    # --- the port's own ---
    device: str = "cuda"  # 'cuda' | 'cuda:N' | 'cpu'; resolved through
    # serve.resolve_device, which raises when CUDA is asked for and absent

    def __post_init__(self):
        if isinstance(self.lr_decay_step, str):
            self.lr_decay_step = list(ast.literal_eval(self.lr_decay_step))

    @property
    def n_classes(self) -> int:
        if self.dataset not in N_CLASSES:
            raise NotImplementedError(
                "Incorrect dataset name {}".format(self.dataset)
            )
        return N_CLASSES[self.dataset]

    @property
    def audio_params(self) -> dict:
        return AUDIO_PARAMS[self.dataset]

    @property
    def spec_shape(self) -> Tuple[int, int]:
        return spectrogram_shape(self.dataset, swin=self.backbone == "swin")

    @property
    def encoder_dim(self) -> int:
        return 1024 if self.backbone == "swin" else 8 * self.encoder_width

    @property
    def bn_groups(self) -> int:
        """BN statistic groups: 1 = sync-BN (global batch); with
        --sync_bn 0, one group per data-parallel replica (DataParallel
        semantics). With one device and no --dp it is 1."""
        if self.sync_bn:
            return 1
        if self.dp > 0:
            return self.dp
        return 1  # the port runs on one device


def add_arguments(parser: argparse.ArgumentParser, dgl: bool = True) -> None:
    """Register the reference CLI surface on `parser`.

    dgl=True mirrors main_dgl.py:24-65; dgl=False adds the extra
    main.py:63-72 flags. Defaults follow the respective reference script.
    """
    d = Config()
    parser.add_argument("--dataset", default=d.dataset, type=str,
                        help="VGGSound, KineticSound, CREMAD, AVE")
    parser.add_argument("--modulation", default=d.modulation, type=str,
                        choices=["Normal", "OGM", "OGM_GE"])
    parser.add_argument("--fusion_method", default=d.fusion_method, type=str,
                        choices=["sum", "concat", "gated", "film"])
    parser.add_argument("--fps", default=d.fps, type=int)
    parser.add_argument("--use_video_frames", default=d.use_video_frames, type=int)
    parser.add_argument("--num_frame", default=d.num_frame, type=int,
                        help="use how many frames for train")
    parser.add_argument("--audio_path", default=d.audio_path, type=str)
    parser.add_argument("--visual_path", default=d.visual_path, type=str)
    parser.add_argument("--preprocessed_path", default=d.preprocessed_path,
                        type=str,
                        help="offline-decoded cache root (tools/"
                             "preprocess_dataset.py); skips host wav/JPEG "
                             "decode + resample")
    parser.add_argument("--preprocessed_write", default=d.preprocessed_write,
                        type=int,
                        help="1 = populate --preprocessed_path on the fly "
                             "from live decodes (first epoch warms the "
                             "cache)")
    parser.add_argument("--batch_size", default=d.batch_size, type=int)
    parser.add_argument("--epochs", default=d.epochs, type=int)
    parser.add_argument("--optimizer", default=d.optimizer, type=str)
    parser.add_argument("--learning_rate",
                        default=0.001 if dgl else 0.002, type=float,
                        help="initial learning rate")
    parser.add_argument("--lr_decay_step",
                        default="[70]" if dgl else "[30,70]", type=str,
                        help="where learning rate decays")
    parser.add_argument("--lr_decay_ratio", default=d.lr_decay_ratio, type=float)
    parser.add_argument("--modulation_starts", default=d.modulation_starts, type=int)
    parser.add_argument("--modulation_ends", default=d.modulation_ends, type=int)
    if dgl:
        parser.add_argument("--alpha", default=4.0, type=float,
                            help="alpha in DGL")
    else:
        parser.add_argument("--alpha", required=True, type=float,
                            help="alpha in OGM-GE")
    parser.add_argument("--ckpt_path", required=True, type=str)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--use_tensorboard", default=False, type=bool)
    parser.add_argument("--tensorboard_path", type=str, default=None)
    parser.add_argument("--random_seed", default=d.random_seed, type=int)
    parser.add_argument("--gpu_ids", default=d.gpu_ids, type=str)
    parser.add_argument("--modality", type=str, default=d.modality)
    parser.add_argument("--backbone", type=str, default=d.backbone)
    parser.add_argument("--total_epoch", default=d.total_epoch, type=int)
    parser.add_argument("--drop", default=d.drop, type=int)
    if not dgl:
        parser.add_argument("--pe", type=int, default=d.pe)
        parser.add_argument("--max", type=float, default=d.max)
        parser.add_argument("--beta", type=float, default=d.beta)
        parser.add_argument("--pretrain", type=bool, default=d.pretrain)
        parser.add_argument("--warmup", type=bool, default=d.warmup)
        parser.add_argument("--gamma", type=float, default=d.gamma)
    # gdl_tpu's flags
    parser.add_argument("--dp", default=d.dp, type=int)
    parser.add_argument("--mp", default=d.mp, type=int)
    parser.add_argument("--compute_dtype", default=d.compute_dtype, type=str)
    parser.add_argument("--fast_dropout_rng", default=int(d.fast_dropout_rng),
                        type=int)
    parser.add_argument("--sync_bn", default=d.sync_bn,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--strict_compat", action="store_true")
    parser.add_argument("--log_grad_csv", default=d.log_grad_csv,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--eval_drop_last", default=d.eval_drop_last,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--save_torch", action="store_true")
    parser.add_argument("--pretrained_path", default=None, type=str)
    parser.add_argument("--resume", default=None, type=str)
    parser.add_argument("--save_every", default=d.save_every, type=int)
    parser.add_argument("--preempt_save", default=d.preempt_save, type=int)
    parser.add_argument("--preempt_sync_every",
                        default=d.preempt_sync_every, type=int)
    parser.add_argument("--num_workers", default=d.num_workers, type=int)
    parser.add_argument("--profile_dir", default=None, type=str)
    parser.add_argument("--encoder_width", default=d.encoder_width, type=int)
    parser.add_argument("--encoder_stages", default=None,
                        type=lambda s: [int(x) for x in s.split(",")],
                        help="blocks per stage, e.g. 1,1,1,1")
    _ints = lambda s: [int(x) for x in s.split(",")]  # noqa: E731
    parser.add_argument("--swin_embed_dim", default=d.swin_embed_dim,
                        type=int)
    parser.add_argument("--swin_depths", default=list(d.swin_depths),
                        type=_ints, help="e.g. 2,2,18,2")
    parser.add_argument("--swin_heads", default=list(d.swin_heads),
                        type=_ints, help="e.g. 4,8,16,32")
    parser.add_argument("--swin_window", default=d.swin_window, type=int)
    parser.add_argument("--swin_img_size", default=d.swin_img_size,
                        type=int)
    parser.add_argument("--swin_patch", default=d.swin_patch, type=int)
    parser.add_argument("--swin_window_resident",
                        default=d.swin_window_resident,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--use_pallas_attn", default=d.use_pallas_attn,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--use_pallas_attn_eval",
                        default=d.use_pallas_attn_eval,
                        type=lambda s: s not in ("0", "false", "False"),
                        help="0 = the plain attention at eval instead "
                             "of the forward-only fused kernel")
    parser.add_argument("--fuse_qkv_gemm", default=d.fuse_qkv_gemm,
                        type=lambda s: s not in ("0", "false", "False"),
                        help="0 = the qkv projection as nn.Linear "
                             "outside the training attention kernel")
    parser.add_argument("--fuse_mlp", default=d.fuse_mlp,
                        type=lambda s: s not in ("0", "false", "False"),
                        help="1 = each Swin block's MLP as one fused "
                             "kernel (recompute backward)")
    parser.add_argument("--compilation_cache_dir", default=None, type=str,
                        help="gdl_tpu's XLA compile cache (ignored by "
                             "the port)")
    parser.add_argument("--device", default=d.device, type=str,
                        help="'cuda' (default; raises when CUDA is "
                             "absent), 'cuda:N' or 'cpu'")


def from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    return Config(**kwargs)
