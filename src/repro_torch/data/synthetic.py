"""Synthetic dataset generators.

``make_classification`` reimplements the scikit-learn/Guyon (2003) generator
the paper uses for both Madelon and the 65536-feature extreme-scale dataset:
informative features are gaussian clusters on hypercube vertices, redundant
features are random linear combinations of informative ones, the rest are
noise probes.

The image-like generators produce class-conditional template + noise data so
the paper's FashionMNIST/CIFAR10 protocols have deterministic, offline-safe
stand-ins with identical dimensionality (real data is not shipped with the
repository; see data/datasets.py for the registry). Copied from
``repro.data.synthetic`` (numpy only) so the port never imports the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["make_classification", "make_image_like", "standardize", "Dataset"]


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]


def make_classification(
    n_samples: int,
    n_features: int,
    *,
    n_informative: int = 5,
    n_redundant: int = 15,
    n_classes: int = 2,
    n_clusters_per_class: int = 2,
    class_sep: float = 1.0,
    flip_y: float = 0.01,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Guyon-style generator (the Madelon recipe)."""
    n_clusters = n_classes * n_clusters_per_class
    # hypercube vertices as cluster centroids
    centroids = rng.choice([-1.0, 1.0], size=(n_clusters, n_informative))
    centroids *= class_sep * (1.0 + 0.2 * rng.random((n_clusters, 1)))

    counts = np.full(n_clusters, n_samples // n_clusters)
    counts[: n_samples % n_clusters] += 1
    xs, ys = [], []
    for k in range(n_clusters):
        a = rng.standard_normal((n_informative, n_informative))
        pts = rng.standard_normal((counts[k], n_informative)) @ a * 0.5
        xs.append(pts + centroids[k])
        ys.append(np.full(counts[k], k % n_classes))
    x_inf = np.concatenate(xs)
    y = np.concatenate(ys).astype(np.int32)

    cols = [x_inf]
    if n_redundant > 0:
        mix = rng.standard_normal((n_informative, n_redundant))
        cols.append(x_inf @ mix)
    n_noise = n_features - n_informative - n_redundant
    if n_noise > 0:
        cols.append(rng.standard_normal((n_samples, n_noise)))
    x = np.concatenate(cols, axis=1).astype(np.float32)

    # shuffle features and samples
    x = x[:, rng.permutation(n_features)]
    perm = rng.permutation(n_samples)
    x, y = x[perm], y[perm]
    if flip_y > 0:
        flip = rng.random(n_samples) < flip_y
        y[flip] = rng.integers(0, n_classes, flip.sum())
    return x, y


def make_image_like(
    n_samples: int,
    n_features: int,
    n_classes: int,
    *,
    template_rank: int = 12,
    noise: float = 0.6,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class templates in a low-rank smooth basis + pixel noise."""
    # smooth basis (random walk, cumulative) emulates spatial correlation
    basis = np.cumsum(rng.standard_normal((template_rank, n_features)), axis=1)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True) + 1e-8
    coef = rng.standard_normal((n_classes, template_rank)) * 3.0
    y = rng.integers(0, n_classes, n_samples).astype(np.int32)
    mix = coef[y] + 0.4 * rng.standard_normal((n_samples, template_rank))
    x = mix @ basis + noise * rng.standard_normal((n_samples, n_features))
    return x.astype(np.float32), y


def standardize(
    x_train: np.ndarray, x_test: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §5.4: zero mean, unit variance per feature (train statistics)."""
    mu = x_train.mean(axis=0, keepdims=True)
    sd = x_train.std(axis=0, keepdims=True) + 1e-8
    return (x_train - mu) / sd, (x_test - mu) / sd
