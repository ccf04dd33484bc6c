"""The kernels' and models' counts against hand arithmetic at a small
shape."""
from bench.counts import PEAKS, bound_s, coo_dw, coo_matmul_T, set_mlp


def test_coo_matmul_T_forward_with_mask():
    # src (10, 4) f32 = 160 B; values + gather idx 6 * 8 = 48; offsets 4 * 8 = 32;
    # bias 3 * 4 = 12; out (3, 4) f32 = 48; mask (3, 4) u8 = 12
    n_bytes, flops = coo_matmul_T.launch(4, 10, 3, 6, bias=True, mask=True)
    assert n_bytes == 160 + 48 + 32 + 12 + 48 + 12
    assert flops == 2 * 4 * 6


def test_coo_dw_with_epilogue():
    # x (5, 2) 40 B, dy (3, 2) 24, rows + cols 7 * 8 = 56, dv 28, dbias 12,
    # mask 6, dz 24
    n_bytes, flops = coo_dw.launch(2, 5, 3, 7, epilogue=True)
    assert n_bytes == 40 + 24 + 56 + 28 + 12 + 6 + 24
    assert flops == 2 * 2 * 7


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound_s(PEAKS["hbm_bytes_per_s"], 0.0) == 1.0
    assert bound_s(0.0, 2 * PEAKS["f32_flops_per_s"]) == 2.0
    assert bound_s(0.0, PEAKS["bf16_flops_per_s"], "bf16_flops_per_s") == 1.0


def test_set_mlp_step_flops_and_epoch_launches():
    # 3 layers of 10, 20, 5 connections at batch 4: forward and dW 4 * B * nnz,
    # dX 2 * B * nnz for layers 1 and 2
    assert set_mlp.step_flops(4, [10, 20, 5]) == 16 * 35 + 8 * 25
    info = dict(layer_dims=[8, 6, 6, 2], nnz=[10, 20, 5], batch=4, steps_per_epoch=2,
                n_test=5, eval_batch=3)
    got = set_mlp.epoch_launches(info)
    # a step: 3 forward + 2 dX launches of A, 3 of F; evaluation: 2 batches x 3
    assert len(got["coo_matmul_T"]) == 2 * 5 + 2 * 3
    assert len(got["coo_dw"]) == 2 * 3

