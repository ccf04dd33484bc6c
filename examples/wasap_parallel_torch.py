"""WASAP-SGD two-phase parallel training demo (paper Algorithm 1) on the
PyTorch port. The twin of ``examples/wasap_parallel.py``; it runs on the
card (kernels A and F) unless given ``--device cpu`` (the plain versions).

Runs BOTH implementations on the same data/model:
  1. the device-resident adaptation (local SGD + SWA + re-sparsify), its K
     workers one after another on one device (``--worker-axis vmap``, the
     only axis one card has)
  2. the faithful async parameter-server emulation (threads + staleness +
     RetainValidUpdates) — the paper's literal protocol

    PYTHONPATH=src python examples/wasap_parallel_torch.py [--workers 3] [--device cpu]
"""
import argparse

from repro_torch.core.wasap import WASAPConfig, WASAPTrainer
from repro_torch.core.wasap_ps import AsyncPSConfig, AsyncParameterServer
from repro_torch.data import datasets
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
from repro_torch.train.trainer import evaluate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument(
        "--worker-axis", default="vmap", choices=("vmap",),
        help="phase-1 worker axis: vmap, the K workers on one device (the "
        "reference's shard_map axis needs several cards)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the plain versions")
    args = ap.parse_args()

    data = datasets.load("fashionmnist", scale=0.03)
    hp = datasets.PAPER_HPARAMS["fashionmnist"]

    def mk():
        return SparseMLP(
            SparseMLPConfig(
                layer_dims=(data.n_features, 96, 96, data.n_classes),
                epsilon=16, activation="all_relu", alpha=hp["alpha"],
                dropout=0.1, init=hp["init"], impl="element",
            ),
            seed=0, device=args.device,
        )

    print("== WASAP (local SGD + SWA + re-sparsify) ==")
    trainer = WASAPTrainer(
        mk(), data,
        WASAPConfig(n_workers=args.workers, phase1_epochs=args.epochs - 2,
                    phase2_epochs=2, sync_every=4, lr=hp["lr"], zeta=0.3,
                    mode="wasap", batch_size=32, worker_axis=args.worker_axis),
    )
    hist = trainer.run()
    print(f"final acc={hist['test_acc'][-1]:.4f} params={hist['n_params'][-1]}")

    print("\n== Faithful async parameter server (threads) ==")
    model = mk()
    ps = AsyncParameterServer(
        model, data,
        AsyncPSConfig(n_workers=args.workers, epochs=args.epochs, lr=hp["lr"],
                      zeta=0.3, batch_size=32, staleness_discount=0.5),
    )
    stats = ps.run()
    print(f"acc={evaluate(model, data.x_test, data.y_test):.4f} "
          f"updates={stats['updates']} evolutions={stats['evolutions']} "
          f"stale_entries_dropped={stats['stale_entries_dropped']}")


if __name__ == "__main__":
    main()
