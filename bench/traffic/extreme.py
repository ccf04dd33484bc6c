"""The paper's extreme-scale dataset (§2.4): a binary task in the Guyon
(2003) recipe, as scikit-learn's ``make_classification`` draws it and as
the program's ``data/synthetic.py``/``data/datasets.py::make_extreme_dataset``
parameterise it, drawn on the device from a ``torch.Generator``.

Informative features are gaussian clusters around hypercube vertices (each
cluster its own random covariance), redundant features random linear
mixtures of the informative ones, the rest noise probes; features and
samples are shuffled, a share ``flip_y`` of labels redrawn, and the split
standardised with the training split's statistics.

Parameters (the traffic file): ``n_samples``, ``n_features``,
``n_informative``, ``n_redundant``, ``n_classes``, ``n_clusters_per_class``,
``class_sep``, ``flip_y``, ``train_share``, ``batch``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def make(p: Dict, gen: torch.Generator, device) -> Tuple[torch.Tensor, ...]:
    """``(x_train, y_train, x_test, y_test)`` on ``device``: f32 features,
    int64 labels."""
    n, n_feat = int(p["n_samples"]), int(p["n_features"])
    n_inf, n_red = int(p["n_informative"]), int(p["n_redundant"])
    n_cls = int(p["n_classes"])
    n_clusters = n_cls * int(p["n_clusters_per_class"])
    f32 = dict(dtype=torch.float32, device=device, generator=gen)

    def uniform(*shape):
        return torch.rand(*shape, **f32)

    centroids = torch.where(uniform(n_clusters, n_inf) < 0.5, -1.0, 1.0)
    centroids = centroids * float(p["class_sep"]) * (1.0 + 0.2 * uniform(n_clusters, 1))
    counts = [n // n_clusters + (k < n % n_clusters) for k in range(n_clusters)]
    x = torch.randn(n, n_feat, **f32)  # the noise probes; the rest is overwritten
    y = torch.empty((n,), dtype=torch.int64, device=device)
    start = 0
    for k, c in enumerate(counts):
        a = torch.randn(n_inf, n_inf, **f32)
        x[start:start + c, :n_inf] = torch.randn(c, n_inf, **f32) @ a * 0.5 + centroids[k]
        y[start:start + c] = k % n_cls
        start += c
    if n_red:
        mix = torch.randn(n_inf, n_red, **f32)
        x[:, n_inf:n_inf + n_red] = x[:, :n_inf] @ mix
    feat_perm = torch.randperm(n_feat, generator=gen, device=device)
    sample_perm = torch.randperm(n, generator=gen, device=device)
    x = x[sample_perm]
    x = x[:, feat_perm]
    y = y[sample_perm]
    flip = uniform(n) < float(p["flip_y"])
    y = torch.where(flip, torch.randint(0, n_cls, (n,), generator=gen, device=device), y)
    n_train = int(float(p["train_share"]) * n)
    mu = x[:n_train].mean(dim=0, keepdim=True)
    sd = x[:n_train].std(dim=0, unbiased=False, keepdim=True) + 1e-8
    x.sub_(mu).div_(sd)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]
