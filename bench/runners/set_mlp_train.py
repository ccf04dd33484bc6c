"""Runner of a SET-MLP training cell: ``SequentialTrainer`` with fused
epochs on an element-sparse model (kernels A, F and G on the card).

Set-up: the dataset is drawn on the device from the seed by the traffic's
generator and copied to the host once (the trainer takes host arrays, as
its users give it); the topology (Erdős–Rényi positions in the canonical
(column, row) order) and the values (He-uniform at the dense fan-in) are
drawn on the device and handed to ``SparseMLP.from_state``. The trainer
runs, in one ``run()`` call, a warm-up epoch (the training set's upload
and the topology's device arrays come with the call; its first three
steps are kept for the comparison) and then the window's epochs as it
runs them: the fused segment, the topology phase (none: SET and pruning
are off in this traffic) and the evaluation.

Kept for the comparison, with nothing added to the window's device work:
every epoch's feed (the permutation the segment is given), the logits of
the evaluation's forward (``trainer.mlp_forward`` under ``evaluate``,
recorded as they are made) with the rows each epoch evaluated, and, at
the window's close, the parameters the last evaluation read and the
accuracy the trainer reported from it.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bench import compare
from bench.reference import set_mlp as ref

CHECK_STEPS = 3
# test rows a block of the reference's evaluation: a gather of the widest
# layer's 10 M connections at 32 rows is 1.3 GB
EVAL_BLOCK = 32


class WindowClosed(Exception):
    """Raised from the trainer's epoch-end hook to end its run at the
    window's close."""


def erdos_renyi_nnz(epsilon: float, n_in: int, n_out: int) -> int:
    """SET's connection count: eps * (n_in + n_out) of n_in * n_out."""
    density = min(1.0, epsilon * (n_in + n_out) / (n_in * n_out))
    return min(n_in * n_out, max(1, int(round(density * n_in * n_out))))


def draw_element_layer(n_in: int, n_out: int, nnz: int, gen: torch.Generator, device):
    """``nnz`` distinct positions of an (n_in, n_out) layer, uniformly,
    as (rows, cols) int32 in the canonical order (sorted by column, then
    row)."""
    total = n_in * n_out
    if nnz == total:
        key = torch.arange(total, device=device, dtype=torch.int64)
    else:
        found = torch.empty(0, dtype=torch.int64, device=device)
        while found.numel() < nnz:
            extra = int((nnz - found.numel()) * 1.05) + 1024
            draw = torch.randint(0, total, (extra,), generator=gen, device=device)
            found = torch.unique(torch.cat([found, draw]))
        keep = torch.randperm(found.numel(), generator=gen, device=device)[:nnz]
        flat = found[keep]  # row * n_out + col
        key, _ = torch.sort((flat % n_out) * n_in + flat // n_out)  # col * n_in + row
    rows = (key % n_in).to(torch.int32)
    cols = (key // n_in).to(torch.int32)
    return rows, cols


class SetMlpTrain:
    rate_metric = "train_samples_per_s"

    def __init__(self, ctx):
        from repro_torch.core.sparsity import ElementTopology
        from repro_torch.data.synthetic import Dataset
        from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
        from repro_torch.train.trainer import SequentialTrainer, TrainerConfig

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfgj, tj = ctx.cell.config, dict(ctx.cell.traffic)
        dims = list(cfgj["layer_dims"])
        if ctx.toy:
            dims, tj = list(cfgj["toy"]["layer_dims"]), dict(tj, **tj["toy"])
        dev = self.device = ctx.device
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        t0 = time.perf_counter()
        xtr, ytr, xte, yte = ctx.cell.generator().make(dict(tj, n_features=dims[0]), gen, dev)
        self.batch = int(tj["batch"])
        host = [t.cpu().numpy() for t in (xtr, ytr, xte, yte)]
        ctx.note(f"set-up: dataset drawn and copied to the host in {time.perf_counter() - t0:.2f} s")
        self.x_train, self.y_train = host[0], host[1].astype(np.int32)
        self.x_test, self.y_test = host[2], host[3].astype(np.int32)
        del xtr, ytr, xte, yte
        opt = cfgj["optimizer"]
        self.lr, self.momentum, self.wd = opt["lr"], opt["momentum"], opt["weight_decay"]
        self.alpha = cfgj["alpha"]
        topos, values, biases, self.layers = [], [], [], []
        for n_in, n_out in zip(dims, dims[1:]):
            nnz = erdos_renyi_nnz(cfgj["epsilon"], n_in, n_out)
            rows, cols = draw_element_layer(n_in, n_out, nnz, gen, dev)
            limit = math.sqrt(6.0 / n_in)  # He-uniform at the dense fan-in
            vals = torch.rand(nnz, generator=gen, device=dev).mul_(2 * limit).sub_(limit)
            bias = torch.zeros(n_out, device=dev)
            self.layers.append(dict(rows=rows.cpu(), cols=cols.cpu(), values=vals.cpu(),
                                    bias=bias.cpu(), out_dim=n_out))
            ctx.note(f"set-up: layer {len(topos)} drawn on the card by {time.perf_counter() - t0:.2f} s")
            topos.append(ElementTopology(n_in, n_out, rows.cpu().numpy(), cols.cpu().numpy()))
            ctx.note(f"set-up: layer {len(topos) - 1}'s host topology made by "
                     f"{time.perf_counter() - t0:.2f} s")
            values.append(vals)
            biases.append(bias)
        ctx.note(f"set-up: topology and values drawn, host topologies made by "
                 f"{time.perf_counter() - t0:.2f} s")
        config = SparseMLPConfig(
            layer_dims=tuple(dims), epsilon=cfgj["epsilon"], activation=cfgj["activation"],
            alpha=self.alpha, dropout=cfgj["dropout"], init=cfgj["init"], impl=cfgj["impl"],
            dtype=cfgj["dtype"])
        self.model = SparseMLP.from_state(config, topos, values, biases, device=dev)
        data = Dataset("extreme", self.x_train, self.y_train, self.x_test, self.y_test,
                       int(tj["n_classes"]))
        self.tc = TrainerConfig(
            epochs=1, batch_size=self.batch, lr=self.lr, momentum=self.momentum,
            weight_decay=self.wd, evolve=bool(tj["evolve"]), pruning=None,
            eval_every=int(tj["eval_every"]), seed=ctx.seed, fused_epochs=True)
        self.trainer = SequentialTrainer(self.model, data, self.tc)
        ctx.note(f"set-up: model and trainer built by {time.perf_counter() - t0:.2f} s")
        self.steps_per_unit = self.trainer._loader().steps_per_epoch
        self.info = {
            "batch": self.batch, "layer_dims": dims,
            "nnz": [int(t.nnz) for t in topos],
            "steps_per_epoch": self.steps_per_unit,
            "n_test": int(host[2].shape[0]), "eval_batch": 512,  # evaluate()'s batch
        }
        self.limits = ctx.cell.limits
        self.note = ctx.note

    def measure(self, seconds, sub):
        """One ``SequentialTrainer.run`` for as many epochs as the window
        takes: epoch 0 is the warm-up (its segment runs steps 1-3 apart,
        for the comparison), the window opens at its end and closes at the
        end of the first epoch that ends ``seconds`` later; the second
        epoch is the profiled stretch of a traced run. Each epoch ends in
        the trainer's own synchronise and evaluation."""
        from repro_torch.train import trainer as trainer_mod

        tr = self.trainer
        segment, forward = tr._segment, trainer_mod.mlp_forward
        w = {"work": 0, "attempted": 0}
        ends, logits, perms = [], [], []
        self.eval_rows, self.perms = [], perms

        def fed_segment(*args):
            # the trainer keeps the segment it found at the run's start
            perms.append(args[5])
            if hasattr(self, "prog"):
                return segment(*args)
            return self._first_steps(segment, *args)

        def recorded_forward(*args, **kwargs):
            out = forward(*args, **kwargs)
            if not kwargs.get("train", False) and not kwargs.get("return_preacts", False):
                logits.append(out)
            return out

        def hook(trainer, epoch):
            now = time.perf_counter()
            if epoch == 0:
                self.note(f"set-up: warm-up epoch ended at {now - self.t_built:.2f} s")
                logits.clear()
                w["t_start"] = now
                sub.begin()
                return
            w["work"] += self.steps_per_unit * self.batch
            w["attempted"] += self.steps_per_unit
            self.eval_rows.append(sum(int(t.shape[0]) for t in logits))
            ends.append(now)
            if epoch == 1:
                sub.end(1, self.steps_per_unit)
            if time.perf_counter() - w["t_start"] < seconds:
                logits.clear()
                return
            w["t_end"] = time.perf_counter()
            lengths = [b - a for a, b in zip([w["t_start"]] + ends, ends)]
            self.note("window epochs (s): " + " ".join(f"{x:.4f}" for x in lengths))
            # the window is closed: what the last evaluation read and made
            self.eval_params = dict(zip(*self._leaves(trainer.model.params())))
            self.eval_logits = torch.cat(logits).float().cpu() if logits else None
            self.eval_acc = float(trainer.history["test_acc"][-1])
            raise WindowClosed

        tr._segment, tr.epoch_end_hook = fed_segment, hook
        trainer_mod.mlp_forward = recorded_forward
        tr.tc = dataclasses.replace(self.tc, epochs=2**31)
        self.t_built = time.perf_counter()
        try:
            tr.run()
        except WindowClosed:
            pass
        finally:
            trainer_mod.mlp_forward = forward
        return w

    def _first_steps(self, segment, params, opt_state, topo, x_all, y_all, perm, lrs, key):
        """The first epoch's segment called in three parts, steps 1, 2-3 and
        the rest (the same program on the same feed; nothing is drawn), with
        the snapshots the comparison reads."""
        names, p0 = self._leaves(params)
        params, state, key, l1 = segment(params, opt_state, topo, x_all, y_all, perm[:1],
                                         lrs[:1], key)
        _, v1 = self._leaves(state.velocity)
        params, state, key, l23 = segment(params, state, topo, x_all, y_all,
                                          perm[1:CHECK_STEPS], lrs[1:CHECK_STEPS], key)
        _, p3 = self._leaves(params)
        self.check_idx = perm[:CHECK_STEPS].cpu().numpy()
        self.prog = {
            "loss": [float(v) for v in torch.cat([l1, l23])],
            # v1 = -lr * (g + wd * p0): the gradient the optimizer got
            "grad": {k: -v / self.lr - self.wd * p for k, v, p in zip(names, v1, p0)},
            "delta": {k: b - a for k, a, b in zip(names, p0, p3)},
        }
        if perm.shape[0] == CHECK_STEPS:
            return params, state, key, torch.cat([l1, l23])
        params, state, key, rest = segment(params, state, topo, x_all, y_all,
                                           perm[CHECK_STEPS:], lrs[CHECK_STEPS:], key)
        return params, state, key, torch.cat([l1, l23, rest])

    @staticmethod
    def _leaves(tree):
        names = [f"{k}.{l}" for k in ("values", "biases") for l in range(len(tree[k]))]
        return names, [t.detach().float().cpu().clone() for k in ("values", "biases")
                       for t in tree[k]]

    def _reference_layers(self, values=None):
        """The seed's topology on the device with the seed's values and
        biases, or with ``values`` (leaf name -> tensor) in their place."""
        dev = self.device
        get = (lambda l, k, name: l[k]) if values is None else (
            lambda l, k, name: values[name])
        return [dict(rows=l["rows"].to(dev).long(), cols=l["cols"].to(dev).long(),
                     values=get(l, "values", f"values.{i}").to(dev),
                     bias=get(l, "bias", f"biases.{i}").to(dev), out_dim=l["out_dim"])
                for i, l in enumerate(self.layers)]

    def reference_snapshot(self, precision: str = "f32"):
        dev = self.device
        batches = [(torch.as_tensor(self.x_train[i], device=dev),
                    torch.as_tensor(self.y_train[i], device=dev).long())
                   for i in self.check_idx]
        return ref.train_steps(self._reference_layers(), batches, alpha=self.alpha,
                               lr=self.lr, momentum=self.momentum, weight_decay=self.wd,
                               precision=precision)

    def reference_eval(self, precision: str = "f32") -> torch.Tensor:
        """The reference's logits over the test set, from the parameters
        the window's last evaluation read (the program's state: the
        reference cannot follow the window's thousands of steps in less
        than the window; the steps are checked from the seed's start)."""
        return ref.logits_in_blocks(self.x_test, self._reference_layers(self.eval_params),
                                    self.alpha, EVAL_BLOCK, self.device, precision)

    def free_program(self) -> None:
        self.trainer = self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _counts(self):
        n_test = int(self.x_test.shape[0])
        return {"feed_rows_missed": compare.feed_rows_missed(
                    [p.cpu().numpy() for p in self.perms], int(self.x_train.shape[0]),
                    self.steps_per_unit * self.batch),
                "eval_rows_missed": sum(abs(n_test - r) for r in self.eval_rows)}

    def readings(self):
        """Every number of the program against the reference (``compare``),
        once the program's state is freed; every number infinite where the
        window raised before its first steps or its close."""
        self.free_program()
        if not (hasattr(self, "prog") and hasattr(self, "eval_params")):
            return {name: math.inf for name in self.limits}
        ref_logits = self.reference_eval()
        out = compare.numbers(self.prog, self.reference_snapshot())
        out.update(compare.eval_numbers(self.eval_logits, self.eval_acc, ref_logits,
                                        self.y_test))
        out.update(self._counts())
        return out

    def control_readings(self, precision: str):
        """The same numbers with the reference in ``precision`` put in the
        program's place (the feed and the rows evaluated stay the
        program's)."""
        self.free_program()
        ref_logits, ctl = self.reference_eval(), self.reference_eval(precision)
        acc = float((ctl.argmax(-1) == torch.as_tensor(self.y_test).long()).float().mean())
        out = compare.numbers(self.reference_snapshot(precision), self.reference_snapshot())
        out.update(compare.eval_numbers(ctl, acc, ref_logits, self.y_test))
        out.update(self._counts())
        return out

    def check(self):
        return compare.judged(self.readings(), self.limits)


def build(ctx):
    return SetMlpTrain(ctx)
