"""Dataset layer: file-list construction + per-sample host decode.

A numpy-only copy of `gdl_tpu/data/datasets.py`. Capability parity with
reference dataset/*.py (SURVEY §2.2), re-architected for an accelerator:
the host does ONLY irreducible IO (wav decode/resample, JPEG decode) and
emits fixed-shape raw arrays

    wave   float32 [sr * seconds]      (tiled / cropped / clipped)
    frames uint8   [T, RAW, RAW, 3]    (decoded at a canonical RAW size)
    label  int

and the entire spectrogram + augmentation pipeline runs on-device inside
the train step (data/preprocess.py) — the reference instead
runs librosa STFT + torchvision transforms per sample in 32 worker
processes (dataset/CramedDataset.py:57-103), its dominant cost at ResNet-18
scale (SURVEY §3.1 hot loops).

List-building semantics preserved per dataset (csv/txt parsing, skip rules,
class-id assignment); known reference quirks are fixed by default and
reproduced under cfg.strict_compat:
  - frame selection: the reference draws a random sort-ed index set and
    then ignores it, reading the FIRST N directory entries in os.listdir
    order (dataset/CramedDataset.py:92-96). strict_compat does first-N
    (sorted for determinism); the default samples N frames uniformly at
    train and takes the first N sorted at eval.
"""

from __future__ import annotations

import csv
import glob
import math
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gdl_tpu_torch.config import AUDIO_PARAMS, Config
from gdl_tpu_torch.data.wav import load_wav

RAW_IMAGE_SIZE = 256  # canonical host decode size; device crops/resizes


def listdir_nohidden(path: str) -> List[str]:
    """Non-hidden entries, full paths (dataset/KSDataset.py:22-23)."""
    return glob.glob(os.path.join(path, "*"))


def _decode_frame(path: str, size: int = RAW_IMAGE_SIZE) -> np.ndarray:
    return _decode_frame_with_size(path, size)[0]


def _decode_frame_with_size(path: str, size: int = RAW_IMAGE_SIZE):
    """(decoded [size,size,3] u8, (orig_h, orig_w)). The original size is
    read from the image header (cheap — no pixel decode) and shipped with
    the batch so the device draws RandomResizedCrop parameters in
    ORIGINAL coordinates, exactly like the reference's torchvision
    transform on the undecoded PIL image (dataset/CramedDataset.py:76-88)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from gdl_tpu_torch.data import native

        decoded = native.decode_jpeg(path, size)  # opt-in; None otherwise
        if decoded is not None:
            from PIL import Image

            with Image.open(path) as img:  # header-only: lazy PIL open
                ow, oh = img.size
            return decoded, (oh, ow)
    from PIL import Image

    with Image.open(path) as img:
        ow, oh = img.size
        img = img.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.uint8), (oh, ow)


def _select_frames(entries: Sequence[str], n: int, train: bool,
                   strict_compat: bool, rng: random.Random) -> List[str]:
    entries = sorted(entries)
    if len(entries) == 0:
        return []
    if strict_compat or not train or len(entries) <= n:
        sel = entries[:n]
    else:
        idx = sorted(rng.sample(range(len(entries)), n))
        sel = [entries[i] for i in idx]
    # pad by repeating the last frame if the clip is short (the reference
    # leaves zeros in the tensor instead — dataset/CramedDataset.py:94)
    while len(sel) < n:
        sel.append(sel[-1])
    return sel


def _load_frames(paths: List[str]) -> np.ndarray:
    return _load_frames_with_sizes(paths)[0]


def _load_frames_with_sizes(paths: List[str]):
    """(frames [T,R,R,3] u8, sizes [T,2] i32 — per-frame original H,W)."""
    frames, sizes = [], []
    for p in paths:
        try:
            f, hw = _decode_frame_with_size(p)
            frames.append(f)
            sizes.append(hw)
        except Exception:
            # corrupt image → black frame slot (dataset/KSDataset.py:182-187)
            frames.append(np.zeros((RAW_IMAGE_SIZE, RAW_IMAGE_SIZE, 3),
                                   np.uint8))
            sizes.append((RAW_IMAGE_SIZE, RAW_IMAGE_SIZE))
    return np.stack(frames), np.asarray(sizes, np.int32)


def _host_rrc_params(rng: random.Random, h: int, w: int):
    """torchvision RandomResizedCrop.get_params, sequential (the exact
    10-attempt loop with per-attempt area/aspect draws and early exit —
    torchvision/transforms/transforms.py; scale (0.08, 1), ratio
    (3/4, 4/3)). Returns (y0, x0, ch, cw) ints. Distribution-identical to
    the vectorized device draw (ops/image_ops.py sample_rrc_box); used by
    the strict_compat host-exact visual path."""
    area = float(h * w)
    log_lo, log_hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = math.exp(rng.uniform(log_lo, log_hi))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            return rng.randint(0, h - ch), rng.randint(0, w - cw), ch, cw
    in_ratio = w / h  # fallback: ratio-clamped center crop
    if in_ratio < 3.0 / 4.0:
        cw, ch = w, int(round(w / (3.0 / 4.0)))
    elif in_ratio > 4.0 / 3.0:
        cw, ch = int(round(h * (4.0 / 3.0))), h
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _load_frames_exact(paths: List[str], rng: random.Random, train: bool,
                       size: int = 224) -> np.ndarray:
    """strict_compat visual path: the torchvision transform runs ON HOST
    at ORIGINAL resolution — crop drawn by _host_rrc_params, PIL
    crop+resize (ONE bilinear resample, exactly the reference's
    dataset/CramedDataset.py:76-101 pixels), p=0.5 horizontal flip; eval
    is the reference's Resize((224,224)). Retires PARITY known-delta #2
    (the default device path resamples original→256² canvas→224, one
    extra bilinear pass). Draw order per frame: crop params then flip,
    frames in selection order — matching the reference's per-frame
    transform invocation. A corrupt frame yields a black slot and
    consumes no draws (KSDataset.py:182-187 semantics)."""
    from PIL import Image

    frames = []
    for p in paths:
        try:
            with Image.open(p) as img:
                img = img.convert("RGB")
                if train:
                    y0, x0, ch, cw = _host_rrc_params(rng, img.height,
                                                      img.width)
                    img = img.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                        (size, size), Image.BILINEAR)
                    if rng.random() < 0.5:
                        img = img.transpose(Image.FLIP_LEFT_RIGHT)
                else:
                    img = img.resize((size, size), Image.BILINEAR)
                frames.append(np.asarray(img, np.uint8))
        except Exception:
            frames.append(np.zeros((size, size, 3), np.uint8))
    return np.stack(frames)


def _cached_sizes(ffile: str, rows: List[int]) -> np.ndarray:
    """Per-frame original sizes for cached clips: the .sizes.npy sidecar
    written next to the frames file (data/cache.py). Caches built before
    the sidecar existed fall back to the canvas size — the pre-round-4
    crop geometry — rather than failing."""
    try:
        arr = np.load(ffile + ".sizes.npy")
        return np.asarray(arr[rows], np.int32)
    except (OSError, ValueError, IndexError):
        return np.full((len(rows), 2), RAW_IMAGE_SIZE, np.int32)


def _fixed_from_wave(wave: np.ndarray, dataset: str,
                     rng: Optional[random.Random]) -> np.ndarray:
    """The tile/crop/pad/clip tail of the audio pipeline on an
    already-resampled waveform (the pure-Python reference numerics —
    shared by the live decode path and the offline-preprocessed cache)."""
    p = AUDIO_PARAMS[dataset]
    sr = p["sample_rate"]
    target = sr * p["seconds"]
    if dataset in ("CREMAD", "AVE"):
        # np.tile(samples, 3)[:3 s] (dataset/CramedDataset.py:61)
        wave = np.tile(wave, 3)[:target]
    else:
        # tile to >= 10 s, then a random crop: 5 s with start in [0, 5 s]
        # (KS/VGGSound, dataset/KSDataset.py:139-146) or 8 s with start in
        # [0, 2 s] (kinect400, dataset/Kinect400.py:120-127) — the bound is
        # per-dataset (AUDIO_PARAMS crop_start_s)
        min_len = sr * 10
        while len(wave) < min_len:
            wave = np.tile(wave, 2)
        hi = sr * p["crop_start_s"]
        start = rng.randint(0, hi) if rng is not None else 0
        wave = wave[start:start + target]
    if len(wave) < target:
        wave = np.pad(wave, (0, target - len(wave)))
    return np.clip(wave, -1.0, 1.0).astype(np.float32)


def _audio_fixed(path: str, dataset: str,
                 rng: Optional[random.Random]) -> np.ndarray:
    """Decode + resample + tile/crop/clip to the dataset's fixed length.

    Uses the native C++ fused pipeline (native/gdl_host.cpp via
    data/native.py) when available; otherwise the pure-Python
    path below (same numerics, tests/test_native.py)."""
    from gdl_tpu_torch.data import native

    p = AUDIO_PARAMS[dataset]
    sr = p["sample_rate"]
    target = sr * p["seconds"]
    if native.available():
        try:
            if dataset in ("CREMAD", "AVE"):
                return native.wav_to_fixed(path, sr, target, tile=3, start=0)
            n_in, rate = native.wav_info(path)
            n_res = n_in * sr // rate  # post-resample length (approx ok)
            tiles, length = 1, max(n_res, 1)
            while length < sr * 10:
                length *= 2
                tiles *= 2
            hi = sr * p["crop_start_s"]
            start = rng.randint(0, hi) if rng is not None else 0
            return native.wav_to_fixed(path, sr, target, tile=tiles,
                                       start=start)
        except ValueError:
            pass  # corrupt/unsupported file → python path below
    wave = load_wav(path, sr)
    return _fixed_from_wave(wave, dataset, rng)


def preprocessed_key(path: str) -> str:
    """Stable cache filename for a source path: full sha1 of the
    normalized path + the basename for human debuggability."""
    import hashlib

    norm = os.path.normpath(path)
    digest = hashlib.sha1(norm.encode()).hexdigest()
    base = os.path.basename(norm.rstrip(os.sep)) or "root"
    return f"{digest}_{base}"


def _npy_meta(path: str):
    """(payload byte offset, shape, dtype) of a .npy file — parsed ONCE
    per clip and memoized by _pre_entry, where np.load would re-parse the
    header (open + ast.literal_eval) every epoch. Returns None on any
    parse problem (the caller treats the clip as uncached). Fortran-order
    arrays are rejected — the cache writer (tools/preprocess_dataset.py)
    only emits C-order."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = np.lib.format._read_array_header(
                f, version)
            if fortran:
                return None
            return f.tell(), shape, dtype
    except Exception:
        return None


def preprocessed_audio_file(root: str, path: str) -> str:
    return os.path.join(root, "audio", preprocessed_key(path) + ".npy")


def preprocessed_frames_file(root: str, path: str) -> str:
    return os.path.join(root, "frames", preprocessed_key(path) + ".npy")


class _AVListDataset:
    """Shared skeleton: a (audio_path, video_dir, label) triplet list."""

    dataset_name: str

    def __init__(self, cfg: Config, mode: str, n_frames: int):
        self.cfg = cfg
        self.mode = mode
        self.n_frames = n_frames
        self.audio: List[str] = []
        self.image: List[str] = []
        self.label: List[int] = []
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.label)

    def set_epoch(self, epoch: int) -> None:
        """Called by the Loader at the top of each epoch so per-sample
        augmentation draws vary across epochs but stay deterministic."""
        self._epoch = epoch

    def _sample_rng(self, idx: int) -> random.Random:
        """Per-(seed, epoch, sample) RNG — thread-safe under the Loader's
        ThreadPoolExecutor (a single shared Random would interleave draws
        nondeterministically across workers, breaking setup_seed's
        host-pipeline determinism)."""
        seed = (self.cfg.random_seed * 1_000_003 + self._epoch) \
            * 1_000_003 + idx
        return random.Random(seed)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        train = self.mode == "train"
        rng = self._sample_rng(idx)
        # the reference draws its random audio-crop start at EVAL time too
        # (dataset/KSDataset.py:143-146 runs in __getitem__ regardless of
        # mode) — reproduced under strict_compat; default eval uses start=0
        # for deterministic reported accuracy
        audio_rng = rng if (train or self.cfg.strict_compat) else None
        if self.cfg.strict_compat:
            # exact-pixel visual path (PARITY delta #2 retired): the
            # torchvision transform runs on host at ORIGINAL resolution.
            # Bypasses the offline cache — its canvas-decoded pixels
            # cannot reproduce the single-resample reference output.
            wave = _audio_fixed(self.audio[idx], self.dataset_name,
                                audio_rng)
            sel = _select_frames(listdir_nohidden(self.image[idx]),
                                 self.n_frames, train, True, rng)
            frames = _load_frames_exact(sel, rng, train)
            sizes = np.full((len(sel), 2), frames.shape[1], np.int32)
            # dict sample, not the usual tuple: the 'host_exact' key is an
            # EXPLICIT marker the device preprocess dispatches on: a shape
            # coincidence (any 224² batch) must not silently skip
            # augmentation
            return {"wave": wave, "frames": frames,
                    "label": self.label[idx], "frame_sizes": sizes,
                    "host_exact": np.uint8(1)}
        root = getattr(self.cfg, "preprocessed_path", "")
        if root:
            cached = self._getitem_preprocessed(idx, train, rng, audio_rng,
                                                root)
            if cached is None and getattr(self.cfg, "preprocessed_write",
                                          False):
                # on-the-fly cache warm-up (--preprocessed_write): write
                # this clip's entry (idempotent/atomic — data/cache.py),
                # then serve from the cache so the sample is byte-equal
                # to every later cached epoch. The failed cached attempt
                # above consumed NO rng draws (it bails on missing files
                # before any), so the retry sees the same stream. Any
                # write/decode failure falls through to live decode.
                if self._write_cache_entry(idx, root):
                    cached = self._getitem_preprocessed(
                        idx, train, rng, audio_rng, root)
            if cached is not None:
                return cached
        wave = _audio_fixed(self.audio[idx], self.dataset_name, audio_rng)
        entries = listdir_nohidden(self.image[idx])
        sel = _select_frames(entries, self.n_frames, train,
                             self.cfg.strict_compat, rng)
        frames, sizes = _load_frames_with_sizes(sel)
        return wave, frames, self.label[idx], sizes

    def _getitem_preprocessed(self, idx, train, rng, audio_rng, root):
        """Offline-cache fast path (tools/preprocess_dataset.py): the
        resampled waveform and the decoded 256^2 frames load as plain
        .npy (frames memory-mapped); only the cheap per-epoch tail
        (tile/crop, frame selection) runs on the host. The augmentation rng draws stay in
        the SAME order as the live path, so a cached epoch is sample-for-
        sample identical to a decoded one (tests/test_preprocessed.py).
        Returns None when either cache file is missing (falls back to
        live decode for that sample)."""
        afile = preprocessed_audio_file(root, self.audio[idx])
        ffile = preprocessed_frames_file(root, self.image[idx])
        nfile = ffile + ".names.npy"
        if not (os.path.exists(afile) and os.path.exists(ffile)
                and os.path.exists(nfile)):
            return None
        # IMPORTANT rng-order note: the live python audio path draws the
        # crop start inside _fixed_from_wave; the live NATIVE path draws
        # it before wav_to_fixed. Both consume exactly one randint from
        # audio_rng before any frame draw — as does this path.
        wave = _fixed_from_wave(np.load(afile), self.dataset_name,
                                audio_rng)
        names = [str(n) for n in np.load(nfile)]
        sel = _select_frames(names, self.n_frames, train,
                             self.cfg.strict_compat, rng)
        pos = {n: i for i, n in enumerate(names)}
        # mmap: only the selected frame rows are read from disk (real
        # KS clips carry ~10-30 decoded frames; training reads 3)
        store = np.load(ffile, mmap_mode="r")
        sel_rows = [pos[n] for n in sel]
        frames = np.ascontiguousarray(store[sel_rows])
        sizes = _cached_sizes(ffile, sel_rows)
        return wave, frames, self.label[idx], sizes

    # -- batched native collate over the offline cache -------------------
    #
    # The per-sample cached path above is dominated by pure Python
    # overhead: np.load header parses (ast.literal_eval + compile) x3
    # files, os.path.exists x3, and the numpy tile/crop/clip tail (as
    # gdl_tpu's profile of the same code found). The Loader calls
    # collate_cached() for whole batches instead: the .npy metadata
    # (payload offset, shape, frame-name list) is parsed ONCE per clip and
    # memoized, every RNG draw stays in Python in the exact per-sample
    # order, and one GIL-released C call (native/gdl_host.cpp
    # gdl_collate_cached) preads waveforms + selected frame rows straight
    # into the final batch arrays. Bitwise-equal to the per-sample path
    # (tests/test_preprocessed.py).

    def _write_cache_entry(self, idx: int, root: str) -> bool:
        """--preprocessed_write: build this clip's cache files (both are
        idempotent — only the missing one is decoded) and invalidate the
        batch path's memoized miss so the next collate_cached picks the
        entry up. Returns False on any decode/write failure."""
        from gdl_tpu_torch.data import cache

        try:
            cache.write_audio(self.audio[idx], self.dataset_name,
                              preprocessed_audio_file(root,
                                                      self.audio[idx]))
            cache.write_frames(self.image[idx],
                               preprocessed_frames_file(root,
                                                        self.image[idx]))
        except Exception:
            return False
        pc = getattr(self, "_pre_cache", None)
        if pc is not None and pc[0] == root:
            pc[1].pop(idx, None)
        return True

    def _pre_entry(self, idx: int, root: str):
        """Memoized per-clip cache metadata, or False when this clip is
        not (validly) cached — the caller then falls back per-sample."""
        cache = getattr(self, "_pre_cache", None)
        if cache is None or cache[0] != root:
            cache = (root, {})
            self._pre_cache = cache
        hit = cache[1].get(idx)
        if hit is not None:
            return hit
        entry: object = False
        try:
            afile = preprocessed_audio_file(root, self.audio[idx])
            ffile = preprocessed_frames_file(root, self.image[idx])
            ameta = _npy_meta(afile)
            fmeta = _npy_meta(ffile)
            names_arr = np.load(ffile + ".names.npy")
            if ameta and fmeta:
                a_off, a_shape, a_dtype = ameta
                f_off, f_shape, f_dtype = fmeta
                rs = RAW_IMAGE_SIZE
                if (a_dtype == np.dtype("<f4") and len(a_shape) == 1
                        and f_dtype == np.dtype("|u1")
                        and f_shape[1:] == (rs, rs, 3)
                        and f_shape[0] == len(names_arr)):
                    names = [str(n) for n in names_arr]
                    pos = {n: i for i, n in enumerate(names)}
                    try:
                        sizes = np.asarray(
                            np.load(ffile + ".sizes.npy"), np.int32)
                        if sizes.shape != (len(names), 2):
                            sizes = None
                    except (OSError, ValueError):
                        sizes = None
                    entry = (afile, a_off, a_shape[0], ffile, f_off,
                             names, pos, sizes)
        except (OSError, ValueError):
            entry = False
        cache[1][idx] = entry
        return entry

    def collate_cached(self, indices, nthreads: int = 1):
        """Whole-batch fast path over the offline-preprocessed cache.
        Returns (wave [B,T] f32, frames [B,n,H,W,3] u8, labels [B] i32)
        or None when unavailable (no cache root, native lib missing, any
        clip uncached) — the caller then uses the per-sample path."""
        root = getattr(self.cfg, "preprocessed_path", "")
        if not root:
            return None
        if getattr(self.cfg, "strict_compat", 0):
            # strict_compat promises the reference's ORIGINAL-resolution
            # single-resample pixels; the cache stores 256² canvas frames,
            # so the batched fast path must defer to the per-sample
            # host-exact path (which bypasses the cache entirely)
            return None
        from gdl_tpu_torch.data import native

        if not native.collate_available():
            return None
        p = AUDIO_PARAMS[self.dataset_name]
        sr = p["sample_rate"]
        target = sr * p["seconds"]
        crop0 = self.dataset_name in ("CREMAD", "AVE")
        train = self.mode == "train"
        rs = RAW_IMAGE_SIZE
        n = self.n_frames
        apaths, aoff, alen, tiled, starts = [], [], [], [], []
        fpaths, foff, rows, sizes = [], [], [], []
        for idx in indices:
            entry = self._pre_entry(idx, root)
            if not entry:
                return None
            afile, a_off, a_len, ffile, f_off, names, pos, szs = entry
            # RNG draw order == _getitem_preprocessed: the audio crop
            # start first (crop datasets only — _fixed_from_wave draws
            # nothing for CREMAD/AVE), then the frame selection
            rng = self._sample_rng(idx)
            audio_rng = rng if (train or self.cfg.strict_compat) else None
            if crop0:
                start, tlen = 0, 3 * a_len
            else:
                hi = sr * p["crop_start_s"]
                start = audio_rng.randint(0, hi) if audio_rng else 0
                tlen = a_len
                while 0 < tlen < sr * 10:
                    tlen *= 2
            sel = _select_frames(names, n, train, self.cfg.strict_compat,
                                 rng)
            sel_rows = [pos[x] for x in sel]
            if szs is not None:
                sizes.append(szs[sel_rows])
            else:  # pre-sidecar cache: canvas-coordinate geometry
                sizes.append(np.full((n, 2), rs, np.int32))
            apaths.append(afile)
            aoff.append(a_off)
            alen.append(a_len)
            tiled.append(tlen)
            starts.append(start)
            fpaths.append(ffile)
            foff.append(f_off)
            rows.extend(sel_rows)
        try:
            out = native.collate_cached(
                apaths, np.asarray(aoff, np.int64),
                np.asarray(alen, np.int64), np.asarray(tiled, np.int64),
                np.asarray(starts, np.int64), target, fpaths,
                np.asarray(foff, np.int64), np.asarray(rows, np.int32),
                n, rs * rs * 3, nthreads=nthreads)
        except ValueError:
            return None  # file IO failed mid-batch; per-sample fallback
        if out is None:
            return None
        wave, frames = out
        frames = frames.reshape(len(indices), n, rs, rs, 3)
        labels = np.asarray([self.label[i] for i in indices], np.int32)
        return wave, frames, labels, np.stack(sizes)


class CremadDataset(_AVListDataset):
    """CREMA-D (dataset/CramedDataset.py:17-110). 6 emotion classes; split
    csvs under data_root; missing audio/visual pairs skipped (:47-52)."""

    dataset_name = "CREMAD"
    CLASS_DICT = {"NEU": 0, "HAP": 1, "SAD": 2, "FEA": 3, "DIS": 4, "ANG": 5}

    def __init__(self, cfg: Config, mode: str = "train",
                 data_root: str = "./dataset/data/"):
        super().__init__(cfg, mode, n_frames=cfg.fps)
        csv_file = os.path.join(
            data_root, cfg.dataset,
            "train.csv" if mode == "train" else "test.csv")
        with open(csv_file, encoding="UTF-8-sig") as f:
            for item in csv.reader(f):
                audio_path = os.path.join(cfg.audio_path, item[0] + ".wav")
                visual_path = os.path.join(
                    cfg.visual_path, "Image-{:02d}-FPS".format(cfg.fps),
                    item[0])
                if os.path.exists(audio_path) and os.path.exists(visual_path):
                    self.audio.append(audio_path)
                    self.image.append(visual_path)
                    self.label.append(self.CLASS_DICT[item[1]])


class KSDataset(_AVListDataset):
    """Kinetics-Sounds (dataset/KSDataset.py:26-201). 34 classes from
    class.txt; per-class dirs; <3-frame videos removed; audio/video lists
    paired by the sorted directory walk."""

    dataset_name = "KineticSound"

    def __init__(self, cfg: Config, mode: str = "train",
                 data_path: str = "./train_test_data/kinect_sound",
                 class_file: str = "dataset/data/KineticSound/class.txt"):
        super().__init__(cfg, mode, n_frames=cfg.use_video_frames)
        with open(class_file) as f:
            raw = f.readline().split(",")
        class_list = []
        for name in raw:
            parts = [p for p in name.split(" ") if p]
            class_list.append("_".join(parts))
        class_dict = {c: i for i, c in enumerate(class_list)}

        sub = ("train_img/Image-01-FPS", "train") if mode == "train" else \
            ("val_img/Image-01-FPS", "test")
        visual_root = os.path.join(data_path, "visual", sub[0])
        audio_root = os.path.join(data_path, "audio", sub[1])

        for class_name in class_list:
            vdir = os.path.join(visual_root, class_name)
            adir = os.path.join(audio_root, class_name)
            if not (os.path.isdir(vdir) and os.path.isdir(adir)):
                continue
            removed = set()
            videos = sorted(os.listdir(vdir))
            for video in videos:
                vpath = os.path.join(vdir, video)
                if len(listdir_nohidden(vpath)) < 3:
                    removed.add(video)
                    continue
                self.image.append(vpath)
                self.label.append(class_dict[class_name])
            for audio in sorted(os.listdir(adir)):
                if audio in removed:
                    continue
                self.audio.append(os.path.join(adir, audio))
        # the reference pairs audio/video by parallel sorted order
        # (dataset/KSDataset.py:66-93); drop any tail mismatch instead of
        # crashing on ragged directories
        n = min(len(self.audio), len(self.image))
        self.audio, self.image, self.label = (
            self.audio[:n], self.image[:n], self.label[:n])


class VGGSoundDataset(_AVListDataset):
    """VGGSound (dataset/VGGSoundDataset.py:19-158). 309 classes; ids
    assigned by first-seen order of TRAIN classes (:91-102); >=3-frame
    videos only; train/test class-set equality asserted (:90)."""

    dataset_name = "VGGSound"

    def __init__(self, cfg: Config, mode: str = "train",
                 csv_path: str = "./data/VGGSound/vggsound.csv",
                 data_path: str = "./train_test_data/vggsound/"):
        super().__init__(cfg, mode, n_frames=cfg.use_video_frames)
        splits = {"train": ([], [], [], []), "test": ([], [], [], [])}
        with open(csv_path) as f:
            for item in csv.reader(f):
                split = item[3]
                if split not in splits:
                    continue
                name = item[0] + "_" + item[1].zfill(6)
                if split == "train":
                    vdir = os.path.join(
                        data_path, "video/train-set-img",
                        "Image-{:02d}-FPS".format(cfg.fps), name + ".mp4")
                    adir = os.path.join(
                        data_path, "audio/train-audios/train-set",
                        name + ".wav")
                else:
                    vdir = os.path.join(
                        data_path, "video/test-set-img",
                        "Image-{:02d}-FPS".format(cfg.fps), name + ".mp4")
                    adir = os.path.join(
                        data_path, "audio/test-audios/test-set",
                        name + ".wav")
                videos, audios, labels, classes = splits[split]
                if os.path.exists(vdir) and os.path.exists(adir) and \
                        len(listdir_nohidden(vdir)) >= 3:
                    videos.append(vdir)
                    audios.append(adir)
                    if item[2] not in classes:
                        classes.append(item[2])
                    labels.append(item[2])
        train_classes = splits["train"][3]
        test_classes = splits["test"][3]
        assert len(train_classes) == len(test_classes)
        class_dict = {c: i for i, c in enumerate(train_classes)}
        videos, audios, labels, _ = splits[mode]
        self.image = videos
        self.audio = audios
        self.label = [class_dict[l] for l in labels]


class AVEDataset(_AVListDataset):
    """AVE (dataset/AVEDataset.py:14-137). 28 classes derived from the TEST
    split file (:43-51); '&'-separated rows; dedup; <200-byte wavs skipped
    (:64); audio 22.05 kHz 3 s n_fft 512 hop 256 + np.resize 224² (:81-88).
    """

    dataset_name = "AVE"

    def __init__(self, cfg: Config, mode: str = "train",
                 data_root: str = "./train_test_data/AVE_Dataset/"):
        super().__init__(cfg, mode, n_frames=cfg.num_frame)
        audio_root = os.path.join(data_root, "Audios")
        split_file = {
            "train": "trainSet.txt", "test": "testSet.txt",
        }.get(mode, "valSet.txt")

        classes: List[str] = []
        with open(os.path.join(data_root, "testSet.txt")) as f:
            for line in f:
                c = line.split("&")[0]
                if c not in classes:
                    classes.append(c)
        class_dict = {c: i for i, c in enumerate(classes)}

        with open(os.path.join(data_root, split_file)) as f:
            for line in f:
                item = line.split("&")
                audio_path = os.path.join(audio_root, item[1] + ".wav")
                visual_path = os.path.join(
                    data_root, "Image-{:02d}-FPS-SE".format(cfg.fps), item[1])
                if os.path.exists(audio_path) and os.path.exists(visual_path):
                    if os.stat(audio_path).st_size < 200:
                        continue
                    if audio_path not in self.audio:
                        self.audio.append(audio_path)
                        self.image.append(visual_path)
                        self.label.append(class_dict[item[0]])


class Kinetics400Dataset(_AVListDataset):
    """Kinetics-400, first 300 sorted classes (dataset/Kinect400.py:26-100);
    <80 KiB audio and <3-frame videos skipped; 16 kHz 8 s crops."""

    dataset_name = "kinect400"

    def __init__(self, cfg: Config, mode: str = "train",
                 data_path: str = "./train_test_data/kinect400"):
        super().__init__(cfg, mode, n_frames=cfg.use_video_frames)
        class_names = sorted(os.listdir(os.path.join(
            data_path, "audio/train")))[:300]
        class_dict = {c: i for i, c in enumerate(class_names)}
        sub = ("train_img/Image-01-FPS", "train") if mode == "train" else \
            ("val_img/Image-01-FPS", "test")
        visual_root = os.path.join(data_path, "visual", sub[0])
        audio_root = os.path.join(data_path, "audio", sub[1])
        for class_name in class_names:
            adir = os.path.join(audio_root, class_name)
            vdir = os.path.join(visual_root, class_name)
            if not (os.path.isdir(adir) and os.path.isdir(vdir)):
                continue
            for audio in sorted(os.listdir(adir)):
                audio_path = os.path.join(adir, audio)
                if os.stat(audio_path).st_size < 80 * 1024:
                    continue
                video_path = os.path.join(vdir, audio.split(".")[0])
                if not os.path.isdir(video_path) or \
                        len(listdir_nohidden(video_path)) < 3:
                    continue
                self.audio.append(audio_path)
                self.image.append(video_path)
                self.label.append(class_dict[class_name])


class AudioSetDataset:
    """Audio-only stub (dataset/Audioset.py:74-166): 16 kHz 5 s clips,
    returns (wave, wave, label) — never wired into the reference scripts;
    provided for capability completeness. The reference's label-lookup bug
    (file_name is a list, :157-160) is fixed: labels come from a
    {basename: class_id} csv mapping."""

    dataset_name = "AudioSet"

    def __init__(self, cfg: Config, mode: str = "train",
                 data_path: str = "./train_test_data/audioset",
                 label_csv: Optional[str] = None):
        self.cfg = cfg
        self.mode = mode
        root = os.path.join(data_path, mode)
        self.audio = sorted(glob.glob(os.path.join(root, "*.wav")))
        self.labels = {}
        if label_csv and os.path.exists(label_csv):
            with open(label_csv) as f:
                for row in csv.reader(f):
                    self.labels[row[0]] = int(row[1])

    def __len__(self):
        return len(self.audio)

    def __getitem__(self, idx):
        path = self.audio[idx]
        sr = 16000
        wave = load_wav(path, sr)
        target = sr * 5
        if len(wave) < target:
            wave = np.tile(wave, -(-target // max(len(wave), 1)))
        wave = np.clip(wave[:target], -1, 1).astype(np.float32)
        name = os.path.splitext(os.path.basename(path))[0]
        return wave, wave, self.labels.get(name, 0)


class AVDataset:
    """Legacy OGM-GE-era loader (dataset/dataset.py:12-113): pickled
    precomputed spectrograms + frame_0000N.jpg stride sampling. Kept for
    capability completeness; unused by the entry scripts (SURVEY §2.2)."""

    def __init__(self, cfg: Config, mode: str = "train",
                 spec_dir: str = "./data/specs", frame_dir: str = "./data/frames"):
        import pickle

        self.cfg = cfg
        self.mode = mode
        self.samples = []
        if os.path.isdir(spec_dir):
            for p in sorted(glob.glob(os.path.join(spec_dir, "*.pkl"))):
                with open(p, "rb") as f:
                    self.samples.append((pickle.load(f), p))
        self.frame_dir = frame_dir

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        spec, path = self.samples[idx]
        name = os.path.splitext(os.path.basename(path))[0]
        fdir = os.path.join(self.frame_dir, name)
        entries = sorted(glob.glob(os.path.join(fdir, "frame_*.jpg")))
        stride = max(len(entries) // max(self.cfg.use_video_frames, 1), 1)
        sel = entries[::stride][: self.cfg.use_video_frames]
        frames = _load_frames(sel) if sel else np.zeros(
            (self.cfg.use_video_frames, RAW_IMAGE_SIZE, RAW_IMAGE_SIZE, 3),
            np.uint8)
        return np.asarray(spec, np.float32), frames, 0


def make_dataset(cfg: Config, mode: str):
    """Dataset dispatch mirroring main_dgl.py:261-282."""
    if cfg.dataset == "CREMAD":
        return CremadDataset(cfg, mode)
    if cfg.dataset == "KineticSound":
        return KSDataset(cfg, mode)
    if cfg.dataset == "VGGSound":
        return VGGSoundDataset(cfg, mode)
    if cfg.dataset == "AVE":
        return AVEDataset(cfg, mode)
    if cfg.dataset == "kinect400":
        return Kinetics400Dataset(cfg, mode)
    raise NotImplementedError(
        "Incorrect dataset name {}! Only support VGGSound, KineticSound and "
        "CREMA-D for now!".format(cfg.dataset))
