"""The yardstick's arithmetic: model FLOPs, kernel bounds, the frozen
classification of kernel names."""

from __future__ import annotations

import pytest

from portbench.harness.kinds import kind_of
from portbench.harness.spec import cost_module, find_cell


def test_model_macs_match_the_published_figures():
    resnet = cost_module("resnet18_dgl").encoder_macs(3, 224, 224)[0]
    swin = cost_module("swin_dgl").encoder_macs(3)[0]
    assert resnet / 1e9 == pytest.approx(1.82, rel=0.01)  # He et al.
    assert swin / 1e9 == pytest.approx(15.4, rel=0.01)  # Liu et al. Table 1


@pytest.mark.parametrize("kind, audio, visual, ms", [
    ("savep", 32, 32, 7.673),  # #2, a batch-32 Swin-B step, one frame
    ("bwd", 32, 32, 2.030),  # #4
    ("eval", 16, 16, 3.836),  # #1, a batch-16 request, one frame
])
def test_window_attention_bounds_match_the_kernel_table(kind, audio, visual,
                                                        ms):
    config = find_cell("swin_b_dgl_vggsound.train_b32").config
    got = cost_module("window_attention").pass_bound_ms(kind, config, audio,
                                                        visual)
    assert got == pytest.approx(ms, abs=5e-4)


def test_maxpool_bound_matches_the_kernel_table():
    config = find_cell("resnet18_dgl_cremad.train_b64").config
    assert cost_module("maxpool_bwd").stem_shapes(config, 64) == (
        [64, 129, 94, 64], [64, 112, 112, 64])
    got = cost_module("maxpool_bwd").step_bound_ms(config, 64)
    assert got == pytest.approx(0.272, abs=5e-4)


def test_training_counts_three_passes_but_the_stems_input_gradient():
    config = find_cell("resnet18_dgl_cremad.train_b64").config
    cost = cost_module("resnet18_dgl")
    train, fwd = cost.train_flops(config, 1), cost.eval_flops(config, 1)
    assert 2.9 * fwd < train < 3 * fwd


@pytest.mark.parametrize("name, kind", [
    ("void gemm::gemm_tile_kernel<float, wa2::ProjBias>(...)",
     "window_attention_proj (#1, #2)"),
    ("void wa_fwd_kernel<float, 32, true>(...)",
     "window_attention (#1, #2, #5, #7 forward)"),
    ("void wa_bwd_kernel<float, 32>(...)", "window_attention_bwd (#4)"),
    ("void wa_bwd_fused_attn_kernel<float>(...)",
     "window_attention_bwd_fused (#3)"),
    ("void gemm::gemm_tile_kernel<float, wa3::Dx>(...)",
     "window_attention_bwd_fused (#3)"),
    ("void gemm::gemm_tile_kernel<float, mlp::Fc1Gelu>(...)",
     "mlp_fused (#15)"),
    ("void sa_bwd_rows_kernel<float>(...)", "self_attention_bwd (#11)"),
    ("void sa_bwd_keys_kernel<float>(...)", "self_attention_bwd (#11)"),
    ("void sa_train_kernel<float>(...)", "self_attention (#10, #12, #13)"),
    ("void sa_eval_kernel<float>(...)", "self_attention (#10, #12, #13)"),
    ("void dropout_mask_kernel<float>(...)", "dropout_mask (#14)"),
    ("void maxpool_bwd_kernel<float>(...)", "maxpool_bwd (#16)"),
    ("void wa_bwd_rows_kernel<float>(...)", "window_attention_rows (#6)"),
    ("void wa_bwd_recompute_kernel<float>(...)",
     "window_attention_bwd_recompute (#7)"),
    ("void wa_bhnd_kernel<float>(...)", "window_attention_bhnd (#8, #9)"),
    ("Memcpy HtoD (Pinned -> Device)", "h2d_copy"),
    ("Memcpy DtoH (Device -> Pageable)", "d2h_copy"),
    ("Memset (Device)", "memset"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("cutlass_80_simt_sgemm_256x128_8x4_nn_align1", "gemm"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32", "convolution"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(...)", "batch_norm"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel",
     "optimizer_foreach"),
])
def test_every_kernel_of_the_table_is_filed_under_its_row(name, kind):
    assert kind_of(name) == kind


@pytest.mark.parametrize("workload", ["resnet18_dgl_cremad.train_b64",
                                      "swin_b_dgl_vggsound.train_b32"])
def test_the_program_runs_the_configuration_the_file_states(workload):
    config = find_cell(workload).config
    program, widths, recipe = (config["program"], config["widths"],
                               config["recipe"])
    assert program["dataset"] == config["dataset"]
    assert program["fps"] == config["frames"]
    assert program["compute_dtype"] == config["compute_dtype"]
    assert (program["alpha"], program["learning_rate"]) == (
        recipe["alpha"], recipe["learning_rate"])
    if config["model"] == "resnet18_dgl":
        assert program["encoder_width"] == widths["width"]
        assert program.get("encoder_stages", [2, 2, 2, 2]) == widths["stages"]
    else:
        assert (program["swin_embed_dim"], program["swin_depths"],
                program["swin_heads"], program["swin_window"]) == (
            widths["embed_dim"], widths["depths"], widths["heads"],
            widths["window"])
