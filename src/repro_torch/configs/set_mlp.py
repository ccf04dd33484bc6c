"""The paper's own SET-MLP architectures (Table 2) + extreme-scale (Table 4).

The paper's tables (``PAPER_*``) live once in the port, in
``repro_torch.data.datasets``, as they do in the reference.
"""
from repro_torch.configs import ArchSpec
from repro_torch.data.datasets import PAPER_ARCHS, PAPER_DATASETS, PAPER_HPARAMS
from repro_torch.models.mlp import SparseMLPConfig

__all__ = ["SPEC", "extreme_config", "mlp_config"]


def mlp_config(dataset: str, impl: str = "element") -> SparseMLPConfig:
    feats, _, _, classes, _ = PAPER_DATASETS[dataset]
    hp = PAPER_HPARAMS[dataset]
    return SparseMLPConfig(
        layer_dims=(feats, *PAPER_ARCHS[dataset], classes),
        epsilon=hp["epsilon"], activation="all_relu", alpha=hp["alpha"],
        dropout=0.3, init=hp["init"], impl=impl,
    )


def extreme_config(n_hidden: int, n_layers: int, epsilon: float) -> SparseMLPConfig:
    """Table 4: 65536-feature artificial dataset, huge hidden layers."""
    return SparseMLPConfig(
        layer_dims=(65536, *([n_hidden] * n_layers), 2),
        epsilon=epsilon, activation="all_relu", alpha=0.5, impl="element",
    )


SPEC = ArchSpec(
    arch_id="set-mlp", family="mlp",
    config=mlp_config("cifar10"),
    smoke=SparseMLPConfig(layer_dims=(64, 32, 16, 4), epsilon=8, impl="element"),
    shapes={},
    source="the paper (Tables 2-4)",
)
