"""Quickstart on the PyTorch port: train the paper's truly sparse SET-MLP
(element/COO connections, All-ReLU, Importance Pruning) on a
FashionMNIST-shaped dataset and print the Table-2-style summary. The twin of
``examples/quickstart.py``; it runs on the card (kernels A, F and G) unless
given ``--device cpu`` (the plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py [--epochs 20] [--scale 0.05] [--device cpu]

As the reference's quickstart, it takes ``TrainerConfig``'s defaults: fused
epochs, and SET evolution on the device between them
(``device_evolution=True``), with no host sync.
"""
import argparse

from repro_torch.core.importance import PruningSchedule
from repro_torch.data import datasets
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
from repro_torch.train.trainer import SequentialTrainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fashionmnist",
                    choices=list(datasets.PAPER_DATASETS))
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--no-prune", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the plain versions")
    args = ap.parse_args()

    data = datasets.load(args.dataset, scale=args.scale)
    hp = datasets.PAPER_HPARAMS[args.dataset]
    hidden = [max(32, h // 10) for h in datasets.PAPER_ARCHS[args.dataset]]
    cfg = SparseMLPConfig(
        layer_dims=(data.n_features, *hidden, data.n_classes),
        epsilon=hp["epsilon"], activation="all_relu", alpha=hp["alpha"],
        dropout=0.2, init=hp["init"], impl="element",
    )
    model = SparseMLP(cfg, seed=0, device=args.device)
    print(f"dataset={args.dataset} arch={cfg.layer_dims} device={model.device} "
          f"sparse params={model.n_params} "
          f"(dense would be {sum(a*b for a, b in zip(cfg.layer_dims, cfg.layer_dims[1:]))})")
    tc = TrainerConfig(
        epochs=args.epochs, batch_size=min(hp["batch"], 64), lr=hp["lr"],
        zeta=0.3,
        pruning=None if args.no_prune else PruningSchedule(
            tau=args.epochs // 2, period=2, percentile=10.0
        ),
    )
    hist = SequentialTrainer(model, data, tc).run(log_every=1)
    print(f"\nfinal: acc={hist['test_acc'][-1]:.4f} "
          f"start_w={hist['n_params'][0]} end_w={hist['n_params'][-1]}")


if __name__ == "__main__":
    main()
