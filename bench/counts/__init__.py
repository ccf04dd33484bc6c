"""Operations and bytes of the program's kernels and models, from shapes.

A kernel's count takes each input byte as read once and each output byte
as written once, for the inputs given (what these inputs need, not what
the kernel reads again); :func:`bound_s` turns a count into the least time
the card could take."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def bound_s(n_bytes: float, n_flops: float, flops_key: str = "f32_flops_per_s") -> float:
    """max(bytes / HBM bandwidth, operations / the peak rate)."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_flops / PEAKS[flops_key])
