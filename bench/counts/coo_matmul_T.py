"""Kernel A (``csrc/coo_matmul_T.cu``): ``out[s, b] = epilogue(sum over the
slots j of segment s of src[gather[j], b] * values[j])`` in the
(features, batch) layout, f32.

One launch reads the source (src_dim, batch), the values and gather
indices (nnz each), the segment offsets (n_segments + 1, int64) and the
bias (n_segments) where there is one, and writes the output (n_segments,
batch) and, in training, the uint8 branch mask of the same shape. It does
2 * batch * nnz operations."""


def launch(batch: int, src_dim: int, n_segments: int, nnz: int, *, bias: bool,
           mask: bool):
    n_bytes = (4 * src_dim * batch + 8 * nnz + 8 * (n_segments + 1)
               + (4 * n_segments if bias else 0)
               + 4 * n_segments * batch + (n_segments * batch if mask else 0))
    return n_bytes, 2.0 * batch * nnz
