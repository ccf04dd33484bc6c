"""A SET-MLP element model's model flops and the kernel launches of one
epoch of ``SequentialTrainer`` (fused segment, then the evaluation).

A training step of batch B: every layer's forward (kernel A, with bias,
and on a hidden layer All-ReLU and its mask, in the store), every layer's
dW (kernel F; G's epilogue on hidden layers), and dX for layers 1 and up
(kernel A over the row-sorted order; layer 0's input needs none). Model
flops: 2 * B * nnz for each of these products, nothing recomputed. The
evaluation runs every layer's forward (A, no mask) on batches of 512."""
from bench.counts import coo_dw, coo_matmul_T


def step_flops(batch: int, nnz) -> float:
    return sum(4.0 * batch * n for n in nnz) + sum(2.0 * batch * n for n in nnz[1:])


def epoch_launches(info):
    """``{"coo_matmul_T": [(bytes, flops), ...], "coo_dw": [...]}`` of one
    epoch: ``steps_per_epoch`` steps, then the evaluation."""
    dims, nnz, B = info["layer_dims"], info["nnz"], info["batch"]
    n_layers = len(nnz)
    a, f = [], []
    for _ in range(info["steps_per_epoch"]):
        for l in range(n_layers):
            hidden = l < n_layers - 1
            a.append(coo_matmul_T.launch(B, dims[l], dims[l + 1], nnz[l], bias=True,
                                         mask=hidden))
            f.append(coo_dw.launch(B, dims[l], dims[l + 1], nnz[l], epilogue=hidden))
            if l >= 1:
                a.append(coo_matmul_T.launch(B, dims[l + 1], dims[l], nnz[l], bias=False,
                                             mask=False))
    n_test, eb = info["n_test"], info["eval_batch"]
    for s in range(0, n_test, eb):
        rows = min(eb, n_test - s)
        for l in range(n_layers):
            a.append(coo_matmul_T.launch(rows, dims[l], dims[l + 1], nnz[l], bias=True,
                                         mask=False))
    return {"coo_matmul_T": a, "coo_dw": f}
