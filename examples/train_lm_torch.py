"""End-to-end LM training on the port: the twin of ``examples/train_lm.py``.

Trains a transformer with the paper's SET sparse FFN (All-ReLU inside the
blocks, host SET evolution every ``--evolve-every`` steps) on the same
synthetic Zipf stream, drawn from numpy, and saves a checkpoint at the end.
The step is ``launch/steps.py::make_train_step``'s: the loss is
``chunked_softmax_xent`` (the reference's example takes its chunks 64
positions at a time, the step 512: the same sum in another order), momentum
SGD (0.9, weight decay 1e-4). On the card (the default) the sparse FFN runs
kernel C forward and kernels D and E backward; ``--device cpu`` runs their
plain versions. The evolution keeps the optimizer's velocity as it is, as
the reference's example does.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m

Not yet: ``--trace``, ``--probe`` and ``--timeline`` (the obs trace and the
training-dynamics probes, ROADMAP Queue 1, item 4) are refused.
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.topology import evolve_block
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import ModelConfig, PatternLM
from repro_torch.tree import tree_leaves

PRESETS = {
    "tiny": dict(vocab=2048, d_model=128, n_layers=4, n_heads=4, n_kv=2,
                 head_dim=32, d_ff=512),
    "100m": dict(vocab=32768, d_model=640, n_layers=12, n_heads=10, n_kv=5,
                 head_dim=64, d_ff=2560),
}
EVOLVE_SEED = 7  # the reference's example draws its SET regrowth from default_rng(7)


def preset_config(preset: str, sparse_density: float = 0.25) -> ModelConfig:
    """The reference's example's model for a preset (f32)."""
    return ModelConfig(
        name=f"sparse-lm-{preset}", **PRESETS[preset],
        ffn="sparse", sparse_density=sparse_density, sparse_block=32,
        sparse_alpha=0.6, dtype="float32", kv_chunk=64,
    )


def synthetic_stream(rng: np.random.Generator, vocab: int, batch: int, seq: int):
    """Zipf-ish token stream with local repetition structure (learnable):
    the reference's draws, as int32 arrays."""
    while True:
        base = rng.zipf(1.5, size=(batch, seq)).clip(1, vocab - 1)
        rep = rng.random((batch, seq)) < 0.3
        base[:, 1:] = np.where(rep[:, 1:], base[:, :-1], base[:, 1:])
        yield base.astype(np.int32)


def evolve_ffn(model: PatternLM, params, zeta: float, rng: np.random.Generator) -> None:
    """Host SET (Algorithm 2) on every sparse FFN, slot by slot, each
    repeat's W_in then W_out (``core.topology.evolve_block``): the model's
    host topologies and ``params``' tiles replaced in place. A remainder
    layer (slot ``rest{i}``, its tiles unstacked in ``params["rest"]``) is
    one repeat."""
    for slot, topos in model.topologies.items():
        in_stack = slot in params["stack"]
        ffn = (params["stack"][slot] if in_stack else params["rest"][int(slot[len("rest"):])])["ffn"]
        vals_in, vals_out = ffn["win"].float().cpu().numpy(), ffn["wout"].float().cpu().numpy()
        if not in_stack:
            vals_in, vals_out = vals_in[None], vals_out[None]
        new_in, new_out = [], []
        for r, (t_in, t_out) in enumerate(topos):
            res_i = evolve_block(t_in, vals_in[r], zeta, rng)
            res_o = evolve_block(t_out, vals_out[r], zeta, rng)
            model.topologies[slot][r] = (res_i.topology, res_o.topology)
            new_in.append(res_i.values)
            new_out.append(res_o.values)
        for name, new in (("win", new_in), ("wout", new_out)):
            ffn[name] = torch.from_numpy(np.stack(new) if in_stack else new[0]).to(
                dtype=ffn[name].dtype, device=ffn[name].device)


def train(model: PatternLM, *, steps: int, batch: int, seq: int, lr: float,
          evolve_every: int, zeta: float, ckpt_dir=None, meta=None, on_step=None,
          verbose: bool = True) -> dict:
    """The reference example's loop on ``model``: ``steps`` train steps on
    ``batch`` x (``seq`` + 1) tokens of the stream (seed 0), host SET every
    ``evolve_every`` steps, a checkpoint of the parameters at the end (in
    ``ckpt_dir``, when given). ``on_step(i, params, metrics)`` runs after
    each step, before its evolution. Returns every step's loss, the
    topologies after each evolution and the final parameters and optimizer
    state; ``model.params`` holds the trained parameters."""
    train_step, opt = make_train_step(model, lr=lr, momentum=0.9)
    params = model.params
    opt_state = opt.init(params)
    stream = synthetic_stream(np.random.default_rng(0), model.cfg.vocab, batch, seq + 1)
    rng = np.random.default_rng(EVOLVE_SEED)
    topo = model.topo_arrays()
    losses, evolved = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        tokens = torch.as_tensor(next(stream), device=model.device).long()
        params, opt_state, metrics = train_step(
            params, opt_state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}, topo)
        losses.append(metrics["loss"])
        if on_step is not None:
            on_step(i, params, metrics)
        if (i + 1) % evolve_every == 0:
            evolve_ffn(model, params, zeta, rng)
            topo = model.topo_arrays()
            evolved.append({slot: [tuple((t.rows.copy(), t.cols.copy()) for t in pair)
                                   for pair in topos]
                            for slot, topos in model.topologies.items()})
            if verbose:
                print(f"  [evolve] step {i + 1}: SET prune/regrow done")
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    model.params = params
    if ckpt_dir is not None:
        ckpt = CheckpointManager(str(ckpt_dir), keep_last=2)
        ckpt.save(steps, params, meta=meta)
        ckpt.wait()
    return dict(losses=[float(v) for v in losses], evolved=evolved, params=params,
                opt_state=opt_state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--sparse-density", type=float, default=0.25)
    ap.add_argument("--evolve-every", type=int, default=50)
    ap.add_argument("--zeta", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default=str(Path("checkpoints") / "train_lm_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the plain versions")
    for flag in ("--trace", "--timeline"):
        ap.add_argument(flag, default=None, metavar="PATH",
                        help="refused: comes with ROADMAP Queue 1, item 4")
    ap.add_argument("--probe", action="store_true",
                    help="refused: comes with ROADMAP Queue 1, item 4")
    args = ap.parse_args(argv)
    if args.trace or args.timeline or args.probe:
        raise NotImplementedError("--trace, --probe and --timeline (the obs trace and the "
                                  "training-dynamics probes) come with ROADMAP Queue 1, item 4")
    cfg = preset_config(args.preset, args.sparse_density)
    model = PatternLM(cfg, seed=0, device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(model.params))
    print(f"preset={args.preset} params={n_params / 1e6:.1f}M "
          f"(sparse FFN density={args.sparse_density}) on {model.device}")
    train(model, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          evolve_every=args.evolve_every, zeta=args.zeta, ckpt_dir=args.ckpt_dir,
          meta={"preset": args.preset})
    print(f"checkpoint saved to {args.ckpt_dir}")


if __name__ == "__main__":
    main()
