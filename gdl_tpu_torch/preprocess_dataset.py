"""Build the offline-decoded cache that the datasets read under
`--preprocessed_path`: counterpart of `tools/preprocess_dataset.py`, on
the port's own host code (`data/cache.py`'s writers, `data/datasets.py`'s
dataset dispatch and cache file names).

    python -m gdl_tpu_torch.preprocess_dataset --dataset CREMAD \
        --audio_path .../AudioWAV --visual_path ... --out /data/cremad_pre \
        [--mode both] [--workers 8] [--use_video_frames 3]

Per clip, under --out:
  audio/<sha1(path)>_<base>.npy   the resampled f32 waveform (the
      pure-Python load_wav numerics; the per-epoch tile and random-crop
      tail still runs at load);
  frames/<sha1(dir)>_<base>.npy   every frame of the clip on the 256^2
      uint8 canvas, with .names.npy and .sizes.npy sidecars, so that the
      per-epoch frame selection and crop draw what the live path draws.

The files are byte for byte those of `tools/preprocess_dataset.py`, so
either package reads a cache that either wrote. Files already written are
skipped (the writers are idempotent and atomic). Host code only: it
trains nothing, touches no device and imports no model.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data.cache import write_audio, write_frames
from gdl_tpu_torch.data.datasets import (
    make_dataset,
    preprocessed_audio_file,
    preprocessed_frames_file,
)


def preprocess(cfg: Config, out_root: str, modes=("train", "test"),
               workers: int = 4, datasets=None) -> int:
    """Decode every (audio, video_dir) pair of the given modes into
    out_root with `workers` threads → the number of clips. `datasets`
    overrides the make_dataset dispatch (datasets rooted elsewhere)."""
    if datasets is None:
        datasets = [make_dataset(cfg, mode) for mode in modes]
    pairs = {}
    for ds in datasets:
        for a, v in zip(ds.audio, ds.image):
            pairs[(a, v)] = None
    with ThreadPoolExecutor(max_workers=workers) as ex:
        jobs = []
        for a, v in pairs:
            jobs.append(ex.submit(write_audio, a, cfg.dataset,
                                  preprocessed_audio_file(out_root, a)))
            jobs.append(ex.submit(write_frames, v,
                                  preprocessed_frames_file(out_root, v)))
        for j in jobs:
            j.result()
    return len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gdl_tpu_torch.preprocess_dataset")
    ap.add_argument("--dataset", default="CREMAD")
    ap.add_argument("--audio_path", required=True)
    ap.add_argument("--visual_path", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", default="both",
                    choices=["train", "test", "both"])
    ap.add_argument("--workers", default=4, type=int)
    ap.add_argument("--use_video_frames", default=3, type=int)
    args = ap.parse_args(argv)
    cfg = Config(dataset=args.dataset, audio_path=args.audio_path,
                 visual_path=args.visual_path,
                 use_video_frames=args.use_video_frames)
    modes = ("train", "test") if args.mode == "both" else (args.mode,)
    n = preprocess(cfg, args.out, modes, args.workers)
    print(f"preprocessed {n} clips -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
