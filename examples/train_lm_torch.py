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

Observability, as the reference's example: ``--trace PATH`` writes a JSONL
span trace (``train.run``, ``train.step`` waiting for the step's loss,
``train.evolve``) and prints its per-span summary; ``--probe`` records a
training-dynamics snapshot of every sparse FFN slot's weights (value L2 and
zero fraction over W_in and W_out, with the SET churn) at each evolution
and at the end, under an ``AnomalyMonitor``, and prints the health table;
``--timeline PATH`` (with ``--probe``) keeps the snapshots as a JSONL
timeline (``python -m repro_torch.obs report PATH`` renders it).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 4 --evolve-every 2 \
        --batch 2 --seq 16 --probe --trace /tmp/t.jsonl --timeline /tmp/tl.jsonl
"""
import argparse
import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
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


def _slot_ffn(params, slot: str):
    """A sparse FFN slot's parameters: ``params["stack"][slot]["ffn"]``, or
    a remainder layer's (slot ``rest{i}``) in ``params["rest"]``."""
    if slot in params["stack"]:
        return params["stack"][slot]["ffn"]
    return params["rest"][int(slot[len("rest"):])]["ffn"]


def evolve_ffn(model: PatternLM, params, zeta: float, rng: np.random.Generator) -> list:
    """Host SET (Algorithm 2) on every sparse FFN, slot by slot, each
    repeat's W_in then W_out (``core.topology.evolve_block``): the model's
    host topologies and ``params``' tiles replaced in place. A remainder
    layer (slot ``rest{i}``, its tiles unstacked in ``params["rest"]``) is
    one repeat. Returns each slot's churn (pruned tiles / tiles), in sorted
    slot order."""
    churn = {}
    for slot, topos in model.topologies.items():
        in_stack = slot in params["stack"]
        ffn = _slot_ffn(params, slot)
        vals_in, vals_out = ffn["win"].float().cpu().numpy(), ffn["wout"].float().cpu().numpy()
        if not in_stack:
            vals_in, vals_out = vals_in[None], vals_out[None]
        new_in, new_out = [], []
        pruned = blocks = 0
        for r, (t_in, t_out) in enumerate(topos):
            res_i = evolve_block(t_in, vals_in[r], zeta, rng)
            res_o = evolve_block(t_out, vals_out[r], zeta, rng)
            model.topologies[slot][r] = (res_i.topology, res_o.topology)
            new_in.append(res_i.values)
            new_out.append(res_o.values)
            pruned += res_i.n_pruned + res_o.n_pruned
            blocks += vals_in[r].shape[0] + vals_out[r].shape[0]
        for name, new in (("win", new_in), ("wout", new_out)):
            ffn[name] = torch.from_numpy(np.stack(new) if in_stack else new[0]).to(
                dtype=ffn[name].dtype, device=ffn[name].device)
        churn[slot] = pruned / max(1, blocks)
    return [churn[s] for s in sorted(churn)]


def record_probe(model: PatternLM, step: int, params, loss, churn=None):
    """The example's probe: per sparse FFN slot (sorted), the value L2 and
    zero fraction over its W_in and W_out tiles (every repeat), from host
    passes (``probes.streamed_value_stats``); gradients are not kept past
    the step, so the snapshot is value/churn only."""
    from repro_torch.obs import probes

    layers = []
    for slot in sorted(model.topologies):
        ffn = _slot_ffn(params, slot)
        st = {}
        for name in ("win", "wout"):
            v = ffn[name].float().cpu().numpy().ravel()
            st[name] = (probes.streamed_value_stats(v), v.size)
        (a, na), (b, nb) = st["win"], st["wout"]
        layers.append({
            "value_l2": float(np.sqrt(a["value_l2"] ** 2 + b["value_l2"] ** 2)),
            "value_zero_frac": (a["value_zero_frac"] * na + b["value_zero_frac"] * nb)
            / max(1, na + nb),
        })
    return probes.record_snapshot(step, "lm", layers=layers, churn=churn,
                                  extra={"loss": float(loss)})


def train(model: PatternLM, *, steps: int, batch: int, seq: int, lr: float,
          evolve_every: int, zeta: float, ckpt_dir=None, meta=None, on_step=None,
          verbose: bool = True, trace=None, probe: bool = False, timeline=None) -> dict:
    """The reference example's loop on ``model``: ``steps`` train steps on
    ``batch`` x (``seq`` + 1) tokens of the stream (seed 0), host SET every
    ``evolve_every`` steps, a checkpoint of the parameters at the end (in
    ``ckpt_dir``, when given). ``on_step(i, params, metrics)`` runs after
    each step, before its evolution. ``trace`` (a path) writes the span
    trace; ``probe`` records the snapshots (:func:`record_probe`) under an
    ``AnomalyMonitor``, into the JSONL file ``timeline`` if given, else in
    memory. Returns every step's loss, the topologies after each evolution,
    the final parameters and optimizer state, and with ``probe`` the
    timeline's events (``"timeline"``); ``model.params`` holds the trained
    parameters."""
    train_step, opt = make_train_step(model, lr=lr, momentum=0.9)
    params = model.params
    opt_state = opt.init(params)
    stream = synthetic_stream(np.random.default_rng(0), model.cfg.vocab, batch, seq + 1)
    rng = np.random.default_rng(EVOLVE_SEED)
    topo = model.topo_arrays()
    losses, evolved = [], []
    sink = None
    if probe:
        from repro_torch.obs import detect
        from repro_torch.obs import timeline as tl

        detect.configure(detect.AnomalyMonitor())
        sink = open(timeline, "w", encoding="utf-8") if timeline else io.StringIO()
        tl.configure(sink, run_id=f"train_lm_torch-{model.cfg.name}",
                     attrs={"model": model.cfg.name})
    trace_ctx = (obs.trace_to(trace, meta={"example": "train_lm_torch", "model": model.cfg.name})
                 if trace else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace_ctx, obs.span("train.run", steps=steps):
        for i in range(steps):
            tokens = torch.as_tensor(next(stream), device=model.device).long()
            with obs.span("train.step", i=i) as sp:
                params, opt_state, metrics = train_step(
                    params, opt_state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]},
                    topo)
                sp.block_on(metrics["loss"])  # the span's close waits for the step
            losses.append(metrics["loss"])
            if on_step is not None:
                on_step(i, params, metrics)
            if (i + 1) % evolve_every == 0:
                with obs.span("train.evolve", step=i + 1):
                    churn = evolve_ffn(model, params, zeta, rng)
                    topo = model.topo_arrays()
                evolved.append({slot: [tuple((t.rows.copy(), t.cols.copy()) for t in pair)
                                       for pair in topos]
                                for slot, topos in model.topologies.items()})
                if verbose:
                    print(f"  [evolve] step {i + 1}: SET prune/regrow done")
                if probe:
                    record_probe(model, i + 1, params, metrics["loss"], churn=churn)
            if verbose and (i % 20 == 0 or i == steps - 1):
                print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                      f"({time.perf_counter() - t0:.1f}s)")
    model.params = params
    if ckpt_dir is not None:
        ckpt = CheckpointManager(str(ckpt_dir), keep_last=2)
        ckpt.save(steps, params, meta=meta)
        ckpt.wait()
    out = dict(losses=[float(v) for v in losses], evolved=evolved, params=params,
               opt_state=opt_state)
    if probe:
        from repro_torch.obs import detect
        from repro_torch.obs import timeline as tl

        record_probe(model, steps, params, losses[-1])  # end-of-run snapshot
        tl.configure(None)
        detect.configure(None)
        if timeline:
            sink.close()  # the writer does not own a handle it is given
            out["timeline"] = tl.read_timeline(timeline)
        else:
            out["timeline"] = [json.loads(line) for line in sink.getvalue().splitlines()]
    return out


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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL obs trace (DESIGN.md §11) and print the per-span "
                    "summary at the end")
    ap.add_argument("--probe", action="store_true",
                    help="record per-layer training-dynamics snapshots at evolution "
                    "boundaries (DESIGN.md §12) and print the end-of-run health table + any "
                    "anomaly alerts")
    ap.add_argument("--timeline", default=None, metavar="PATH",
                    help="with --probe: also persist the snapshot timeline as JSONL (render "
                    "later with `python -m repro_torch.obs report`)")
    args = ap.parse_args(argv)
    cfg = preset_config(args.preset, args.sparse_density)
    model = PatternLM(cfg, seed=0, device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(model.params))
    print(f"preset={args.preset} params={n_params / 1e6:.1f}M "
          f"(sparse FFN density={args.sparse_density}) on {model.device}")
    out = train(model, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                evolve_every=args.evolve_every, zeta=args.zeta, ckpt_dir=args.ckpt_dir,
                meta={"preset": args.preset}, trace=args.trace, probe=args.probe,
                timeline=args.timeline if args.probe else None)
    print(f"checkpoint saved to {args.ckpt_dir}")
    if args.probe:
        from repro_torch.obs import timeline as tl

        print("\n== training-dynamics health (DESIGN.md §12) ==")
        print(tl.render_report(out["timeline"]))
        if args.timeline:
            print(f"timeline written to {args.timeline}")
    if args.trace:
        summary = obs.summarize_events(obs.read_events(args.trace))
        print(f"\ntrace written to {args.trace} ({summary['n_events']} events)")
        print(obs.format_summary(summary))


if __name__ == "__main__":
    main()
