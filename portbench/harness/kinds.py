"""The kinds of device operation, by the CUDA kernel's name: a frozen
copy of `gdl_tpu_torch/profile_step.py::KINDS` (first match wins), so
that a later change to the program cannot move a kernel between rows
of the yardstick. Copies and sets between host and device are kinds of
their own here ("h2d_copy", "d2h_copy", "d2d_copy", "memset"), ahead
of the rows that would take them by name."""

from __future__ import annotations

KINDS = (
    ("h2d_copy", ("memcpy htod",)),
    ("d2h_copy", ("memcpy dtoh",)),
    ("d2d_copy", ("memcpy dtod",)),
    ("memset", ("memset",)),
    ("window_attention_bwd_fused (#3)", ("wa3::", "wa_bwd_fused")),
    ("mlp_fused (#15)", ("mlp::",)),
    ("window_attention_proj (#1, #2)", ("wa2::",)),
    ("self_attention_bwd (#11)", ("sa_bwd_rows_kernel",
                                  "sa_bwd_keys_kernel")),
    ("self_attention (#10, #12, #13)", ("sa_train_kernel", "sa_eval_kernel",
                                        "gemm_tile_kernel")),
    ("dropout_mask (#14)", ("dropout_mask_kernel",)),
    ("maxpool_bwd (#16)", ("maxpool_bwd_kernel",)),
    ("window_attention_rows (#6)", ("wa_bwd_rows_kernel",)),
    ("window_attention_bwd_recompute (#7)", ("wa_bwd_recompute_kernel",)),
    ("window_attention_bhnd (#8, #9)", ("wa_bhnd_kernel",)),
    ("window_attention_bwd (#4)", ("wa_bwd_kernel",)),
    ("window_attention (#1, #2, #5, #7 forward)", ("wa_fwd_kernel",)),
    ("batch_norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
    ("gemm", ("cublas", "gemv")),
    ("convolution", ("cudnn", "conv", "wgrad", "dgrad", "xmma", "implicit",
                     "nchwToNhwc", "nhwcToNchw", "fft2d",
                     "pointwise_mult_and_sum_complex", "flip_filter")),
    ("gemm", ("gemm", "cutlass", "nvjet")),
    ("layer_norm", ("layer_norm", "layernorm", "GammaBeta")),
    ("roll", ("roll_cuda",)),
    ("pooling", ("max_pool", "avg_pool")),
    ("pad", ("reflection_pad",)),
    ("sort", ("RadixSort",)),
    ("fft", ("fft",)),
    ("optimizer_foreach", ("multi_tensor", "foreach")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "index", "gather",
                     "scatter", "fill")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, words in KINDS:
        if any(w.lower() in low for w in words):
            return kind
    return "other"
