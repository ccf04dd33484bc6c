"""Architecture registry: the 10 assigned archs and the paper's own SET-MLPs.
Twin of ``repro.configs``.

Each ``src/repro_torch/configs/<arch>.py`` defines ``SPEC: ArchSpec`` with the
exact published FULL config, a structurally identical reduced SMOKE config,
and the shape-cell applicability map, as the reference's do (dataclass
literals, copied). The port builds every arch: the ``PatternLM`` archs and
the encoder-decoder ``whisper-medium`` (``models.whisper``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

__all__ = ["SHAPES", "ArchSpec", "get_spec", "list_archs"]

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                      # moe | dense | vlm | ssm | hybrid | audio | mlp
    config: object                   # ModelConfig | WhisperConfig | SparseMLPConfig
    smoke: object
    shapes: Dict[str, object]        # shape_id -> True | "skip reason"
    prefix_tokens: int = 0           # vlm image prefix (stub embeddings)
    source: str = ""

    def runnable_shapes(self):
        return [s for s, v in self.shapes.items() if v is True]


_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "paligemma-3b": "paligemma_3b",
    "qwen1.5-0.5b": "qwen15_05b",
    "gemma3-27b": "gemma3_27b",
    "internlm2-1.8b": "internlm2_18b",
    "gemma2-2b": "gemma2_2b",
    "whisper-medium": "whisper_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "set-mlp": "set_mlp",
    "jamba2-mini": "jamba2_mini",
}
# resolved by get_spec, left out of list_archs: the reference's ten archs
# are the ones both packages have
_NOT_LISTED = ("set-mlp", "jamba2-mini")


def list_archs():
    return [k for k in _MODULES if k not in _NOT_LISTED]


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SPEC
