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

import dataclasses
import zlib
from typing import Dict, Iterator, Tuple

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


def make_extreme_dataset(
    n_samples: int = 10000, n_features: int = 65536, *, seed: int = 7, scale: float = 1.0
) -> Dataset:
    """Paper §2.4: binary task, 65536 features, 70/30 split (scalable)."""
    n_samples = max(64, int(n_samples * scale))
    rng = np.random.default_rng(seed)
    x, y = make_classification(
        n_samples, n_features, n_informative=32, n_redundant=96, n_classes=2,
        n_clusters_per_class=4, class_sep=1.0, rng=rng,
    )
    n_train = int(0.7 * n_samples)
    x_train, x_test = standardize(x[:n_train], x[n_train:])
    return Dataset("extreme", x_train, y[:n_train], x_test, y[n_train:], 2)


@dataclasses.dataclass
class StreamingExtremeDataset:
    """Per-batch-generated extreme-scale dataset for the XL substrate
    (DESIGN.md §7): the paper-size (n, 65536) design matrix would itself
    dwarf host RAM at full sample counts, so nothing larger than one
    (batch, n_features) block ever exists.

    The generating distribution is the Guyon recipe ``make_extreme_dataset``
    uses — gaussian clusters on hypercube vertices in an informative
    subspace, random linear mixtures for the redundant block, noise probes
    elsewhere — but factored so only the *task parameters* (centroids,
    per-cluster transforms, the redundant mixing matrix, the feature
    permutation: a few MB, sample-count independent) are resident, and each
    batch is drawn from a PRNG keyed on ``(seed, batch_index)``. Batches are
    therefore deterministic, replayable after restart-from-checkpoint and
    independent of how many were generated before — the streaming analogue
    of ``ShardedLoader``'s replayable epochs.
    """

    n_features: int = 65536
    batch_size: int = 128
    n_informative: int = 32
    n_redundant: int = 96
    n_classes: int = 2
    n_clusters_per_class: int = 4
    class_sep: float = 1.0
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        k = self.n_classes * self.n_clusters_per_class
        self._centroids = rng.choice(
            [-1.0, 1.0], size=(k, self.n_informative)
        ) * self.class_sep * (1.0 + 0.2 * rng.random((k, 1)))
        self._transforms = (
            rng.standard_normal((k, self.n_informative, self.n_informative))
            * 0.5
        )
        self._mix = rng.standard_normal((self.n_informative, self.n_redundant))
        self._feat_perm = rng.permutation(self.n_features)

    def batch(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic batch ``index`` — (x, y) of shape
        ((batch_size, n_features), (batch_size,))."""
        # negative indices (the reserved test range) wrap to the top of the
        # 63-bit space — SeedSequence entropy must be non-negative
        rng = np.random.default_rng((self.seed, int(index) % (2 ** 63)))
        b = self.batch_size
        k = self._centroids.shape[0]
        cluster = rng.integers(0, k, b)
        pts = rng.standard_normal((b, self.n_informative))
        x_inf = (
            np.einsum("bi,bij->bj", pts, self._transforms[cluster])
            + self._centroids[cluster]
        )
        y = (cluster % self.n_classes).astype(np.int32)
        x = np.empty((b, self.n_features), np.float32)
        n_body = self.n_informative + self.n_redundant
        x[:, :self.n_informative] = x_inf
        x[:, self.n_informative:n_body] = x_inf @ self._mix
        x[:, n_body:] = rng.standard_normal((b, self.n_features - n_body))
        return x[:, self._feat_perm], y

    def epoch(
        self, epoch: int, steps_per_epoch: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``steps_per_epoch`` fresh batches; epoch e replays batch indices
        ``[e * steps, (e+1) * steps)`` exactly (no sample ever repeats —
        the stream is effectively infinite at extreme scale)."""
        for i in range(steps_per_epoch):
            yield self.batch(epoch * steps_per_epoch + i)

    def test_set(self, n_batches: int = 4) -> Tuple[np.ndarray, np.ndarray]:
        """A small held-out split from a reserved index range."""
        xs, ys = zip(*(self.batch(-(i + 1)) for i in range(n_batches)))
        return np.concatenate(xs), np.concatenate(ys)
