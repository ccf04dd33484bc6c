"""Registry of the paper's five evaluation datasets (Table 1), copied from
``repro.data.datasets`` (numpy only) so the port never imports the JAX
package; ``load`` gives the same arrays for the same arguments.

Real data is not shipped with the repository, so each entry is a
deterministic synthetic clone with *identical dimensionality and class count*
(scaled sample counts by default; pass scale=1.0 for paper-size). Domains are
mimicked: microarray (high-dim low-sample), physics (low-dim tabular),
Madelon (the exact Guyon generator the paper's own artificial data uses),
and image-like data for FashionMNIST/CIFAR10.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from repro_torch.data.synthetic import Dataset, make_classification, make_image_like, standardize

# name -> (features, train_n, test_n, classes, kind)
PAPER_DATASETS: Dict[str, tuple] = {
    "leukemia": (54675, 1397, 699, 18, "tabular_highdim"),
    "higgs": (28, 105000, 50000, 2, "tabular"),
    "madelon": (500, 2000, 600, 2, "madelon"),
    "fashionmnist": (784, 60000, 10000, 10, "image"),
    "cifar10": (3072, 50000, 10000, 10, "image"),
}

# paper Table 7 hyperparameters: epsilon, lr, batch, init, alpha
PAPER_HPARAMS: Dict[str, dict] = {
    "leukemia": dict(epsilon=10, lr=0.005, batch=5, init="normal", alpha=0.75),
    "higgs": dict(epsilon=10, lr=0.01, batch=128, init="xavier", alpha=0.05),
    "madelon": dict(epsilon=10, lr=0.01, batch=32, init="normal", alpha=0.5),
    "fashionmnist": dict(epsilon=20, lr=0.01, batch=128, init="he_uniform", alpha=0.6),
    "cifar10": dict(epsilon=20, lr=0.01, batch=128, init="he_uniform", alpha=0.75),
}

# paper Table 2 architectures (hidden sizes)
PAPER_ARCHS: Dict[str, list] = {
    "leukemia": [27500, 27500],
    "higgs": [1000, 1000, 1000],
    "madelon": [400, 100, 400],
    "fashionmnist": [1000, 1000, 1000],
    "cifar10": [4000, 1000, 4000],
}


def load(name: str, *, scale: float = 1.0, seed: int = 0) -> Dataset:
    name = name.lower()
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {list(PAPER_DATASETS)}")
    n_feat, n_train, n_test, n_cls, kind = PAPER_DATASETS[name]
    n_train = max(n_cls * 8, int(n_train * scale))
    n_test = max(n_cls * 4, int(n_test * scale))
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**31)
    n = n_train + n_test
    if kind == "madelon":
        x, y = make_classification(
            n, n_feat, n_informative=5, n_redundant=15, n_classes=2,
            n_clusters_per_class=8, class_sep=1.2, rng=rng,
        )
    elif kind == "tabular":
        x, y = make_classification(
            n, n_feat, n_informative=18, n_redundant=6, n_classes=n_cls,
            n_clusters_per_class=3, class_sep=0.8, flip_y=0.05, rng=rng,
        )
    elif kind == "tabular_highdim":
        x, y = make_classification(
            n, n_feat, n_informative=64, n_redundant=256, n_classes=n_cls,
            n_clusters_per_class=1, class_sep=2.5, rng=rng,
        )
    elif kind == "image":
        x, y = make_image_like(n, n_feat, n_cls, rng=rng)
    else:
        raise AssertionError(kind)
    x_train, x_test = standardize(x[:n_train], x[n_train:])
    return Dataset(name, x_train, y[:n_train], x_test, y[n_train:], n_cls)
