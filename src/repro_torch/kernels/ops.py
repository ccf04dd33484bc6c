"""Public ops for sparse linear layers: the forward-only (serving) entry of
the element (COO) path. The training entries (``espmm`` with its
hand-derived backward) come with the training slice, the block entries with
the block slice."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparsity import (
    SPMM_INFER_ELEMS,
    SPMM_INFER_NNZ,
    ElemTopoArrays,
    element_spmm,
    element_spmm_segment,
)

__all__ = ["espmm_infer"]


def espmm_infer(
    x: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    chunk: Optional[int] = None,
    col_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Element-sparse ``y = x @ W``, inference dispatch.

    On the card every size goes through kernel A in the reference's
    (features, batch) layout. On the CPU the plain path keeps the reference's
    forward-only thresholds (``SPMM_INFER_*``): scatter-add for small
    problems, the chunked segment sum beyond.
    """
    if x.device.type == "cpu":
        nnz = int(values.shape[0])
        batch = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        if nnz < SPMM_INFER_NNZ and batch * nnz < SPMM_INFER_ELEMS:
            return element_spmm(x, values, topo.rows, topo.cols, out_dim)
    return element_spmm_segment(
        x, values, topo.rows, topo.cols, out_dim, chunk=chunk, col_ptr=col_ptr
    )
