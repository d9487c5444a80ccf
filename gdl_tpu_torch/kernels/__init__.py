"""Build and load the port's hand-written CUDA kernels.

Each library is one `.cu` file in this directory with a plain C
interface (no PyTorch headers, so nvcc takes seconds, not minutes); code
two libraries share lives in a `.cuh` header here. At first use a
library is compiled by nvcc for `sm_90a` into a shared library under
`build/` (listed in .gitignore) and loaded with ctypes. A library is
named by a hash of its source, the headers and the flags, so an edited
source is rebuilt and a built one is reused. Nothing is compiled or
loaded at import time.

`launch_counts` holds one plain integer per kernel. Each op wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels (`chip_smoke.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_uint, _i64 = ctypes.c_uint, ctypes.c_longlong

# source file and C entry points (name -> (argtypes, restype)) per library
LIBRARIES = {
    "window_attention_eval": (
        "window_attention_eval.cu",
        {"gdl_wa_eval_launch": ([_vp] * 7 + [_int] * 7 + [_float, _int, _vp],
                                _int)},
    ),
    "window_attention_train": (
        "window_attention_train.cu",
        {"gdl_wa_savep_launch": ([_vp] * 8 + [_int] * 7
                                 + [_float, _int, _vp], _int),
         "gdl_wa_qkv_savep_launch": ([_vp] * 5 + [_int] * 7
                                     + [_float, _int, _vp], _int),
         "gdl_wa_bwd_launch": ([_vp] * 5 + [_int] * 6 + [_float, _int, _vp],
                               _int),
         "gdl_wa_bwd_delta_launch": ([_vp] * 6 + [_int] * 6
                                     + [_float, _int, _vp], _int),
         "gdl_wa_bwd_fused_launch": ([_vp] * 10 + [_int] * 7
                                     + [_float, _int, _vp], _int),
         "gdl_wa_qkv_fwd_launch": ([_vp] * 4 + [_int] * 7
                                   + [_float, _int, _vp], _int),
         "gdl_wa_bwd_recompute_launch": ([_vp] * 6 + [_int] * 7
                                         + [_float, _int, _vp], _int),
         "gdl_wa_qkv_savep_rows_launch": ([_vp] * 5 + [_int] * 7
                                          + [_float, _int, _vp], _int),
         "gdl_wa_bwd_rows_launch": ([_vp] * 5 + [_int] * 7
                                    + [_float, _int, _vp], _int)},
    ),
    "window_attention_bhnd": (
        "window_attention_bhnd.cu",
        {"gdl_wa_bhnd_launch": ([_vp] * 6 + [_int] * 6 + [_float, _int, _vp],
                                _int),
         "gdl_wa_packed_launch": ([_vp] * 6 + [_int] * 6
                                  + [_float, _int, _vp], _int)},
    ),
    "maxpool_bwd": (
        "maxpool_bwd.cu",
        {"gdl_maxpool_bwd_launch": ([_vp] * 3 + [_int] * 5 + [_vp], _int)},
    ),
    "self_attention_eval": (
        "self_attention_eval.cu",
        {"gdl_sa_eval_launch": ([_vp] * 4 + [_int] * 5 + [_float, _int, _vp],
                                _int)},
    ),
    "self_attention_train": (
        "self_attention_train.cu",
        {"gdl_sa_fwd_launch": ([_vp] * 8 + [_int] * 5
                               + [_float, _int, _uint, _float] + [_i64] * 3
                               + [_int, _vp], _int),
         "gdl_sa_qkv_fwd_launch": ([_vp] * 6 + [_int] * 5
                                   + [_float, _int, _uint, _float]
                                   + [_i64] * 3 + [_int, _vp], _int),
         "gdl_sa_bwd_launch": ([_vp] * 7 + [_int] * 5
                               + [_float, _int, _uint, _float] + [_i64] * 3
                               + [_int, _vp], _int)},
    ),
    "dropout_mask": (
        "dropout_mask.cu",
        {"gdl_dropout_mask_launch": ([_vp] + [_i64] * 4 + [_vp, _uint,
                                                           _float, _int, _vp],
                                     _int)},
    ),
    "mlp_fused": (
        "mlp_fused.cu",
        {"gdl_mlp_fused_launch": ([_vp] * 7 + [_int] * 4 + [_vp], _int)},
    ),
}

launch_counts: Dict[str, int] = {"window_attention_qkv_fused_eval": 0,
                                 "window_attention_qkv_fused_savep": 0,
                                 "window_attention_qkv_fused_bwd": 0,
                                 "window_attention_qkv_savep": 0,
                                 "window_attention_qkv_fused_bwd_delta": 0,
                                 "window_attention_qkv_fused_bwd_fused": 0,
                                 "window_attention_qkv_savep_rows": 0,
                                 "window_attention_qkv_bwd_rows": 0,
                                 "window_attention_qkv_fwd": 0,
                                 "window_attention_qkv_bwd_recompute": 0,
                                 "window_attention_bhnd": 0,
                                 "window_attention_packed": 0,
                                 "mlp_fused": 0,
                                 "max_pool_3x3_s2_bwd": 0,
                                 "self_attention_fused_fwd": 0,
                                 "self_attention_qkv_fwd": 0,
                                 "self_attention_fused_bwd": 0,
                                 "self_attention_fused_eval": 0,
                                 "prng_dropout_mask": 0}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, dict] = {}  # name -> {"seconds", "ptxas"}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((KERNEL_DIR / LIBRARIES[name][0]).read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every library in `names` (default: all) that is not built
    yet, one nvcc process per source, all started together. Raises with
    the compiler's output if any build fails."""
    names = list(LIBRARIES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    for name in set(names) - set(todo):
        build_log.setdefault(name, {"seconds": 0.0, "ptxas": ""})
    nvcc = _nvcc() if todo else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        path = _lib_path(name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(KERNEL_DIR / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: build_log[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
