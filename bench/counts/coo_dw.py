"""Kernel F (``csrc/coo_dw.cu``) with kernel G's epilogue:
``dv[j] = sum_b x[rows[j], b] * dz[cols[j], b]`` with, on a hidden layer,
``dz = where(mask, dy, slope * dy)`` made in the same launch, and the
bias's gradient ``dbias = dz.sum(1)``; f32.

One launch reads x (n_in, batch), dy (n_out, batch), the slots' rows and
columns (nnz each) and, with the epilogue, the mask (n_out, batch, uint8);
it writes dv (nnz), dbias (n_out) and, with the epilogue, dz (n_out,
batch). It does 2 * batch * nnz operations."""


def launch(batch: int, n_in: int, n_out: int, nnz: int, *, epilogue: bool):
    n_bytes = (4 * n_in * batch + 4 * n_out * batch + 8 * nnz + 4 * nnz + 4 * n_out
               + (n_out * batch + 4 * n_out * batch if epilogue else 0))
    return n_bytes, 2.0 * batch * nnz
