"""Runner of an LM training cell: the port's ``PatternLM`` (built from the
configuration's Hugging Face ``JambaConfig`` keys) trained by
``launch.steps.make_train_step`` (momentum SGD, its update in place),
remat per layer, dropless MoE over the held experts.

Set-up: the weights are drawn on the card from the seed, the optimizer's
f32 velocity made, and the first three steps run on the traffic's stream
(drawn on the card from the seed). Kept in host memory for the check: the
step-0 weights, step 1's gradients (as the optimizer gets them) and
weights after it, every step's loss, step 1's tokens, and of step 1's
forward each MoE layer's input, output and its router's top-k choices and
gates, and the first Mamba layer's scan output ``y``. Step 2's update is
checked as it is made (``momentum_diff``, below), on the card a piece at
a time; only its numbers are kept.

The window runs whole steps, each on a fresh draw of the stream; its first
step is the profiled stretch of a traced run.

The check frees the program's state and runs the plain f32 reference
(``reference/jamba.py``) layer by layer from the step-0 weights on step
1's tokens, its MoE layers routed by the program's recorded choices (its
gates its own), comparing as each gradient is made:

* ``grad_diff``: the worst leaf's ||g_prog - g_ref|| over max(its
  ||g_ref||, the median leaf's), leaves under a thousandth of the median
  left out;
* ``update_diff``: the worst leaf's ||(p1 - p0) - (r1 - p0)|| over
  max(||r1 - p0||, the median leaf's), with r1 the reference's
  ``p0 - lr * g_ref`` rounded to the leaf's dtype as the program stores it
  (leaves whose r1 equals p0 left out);
* ``momentum_diff``: the same of step 2's weights p2 against
  ``p1 + (mu * v1 - lr * g2)`` rounded to the leaf's dtype, with
  ``v1 = -lr * g1`` from the kept step-1 gradient and ``g2`` the gradient
  step 2's update gets (weight decay added to each gradient where the
  configuration has it): plain optimizer arithmetic, the velocity carried
  from step 1 to step 2 included;
* ``ssm_out_diff``: ||y_prog - y_ref|| / ||y_ref|| of the first Mamba layer;
* ``route_disagree``: the share of step 1's (token, choice) entries whose
  expert is not in the reference's own f32 top-k of that token;
* ``moe_rows_missed``: over the MoE layers, the held entries the program's
  router chose that its experts did not compute exactly once, read from
  what the layer gave out (:func:`entries_missed`).

Readings with no limit, for the record: ``loss_gap.step1`` (|L_prog -
L_ref| / L_ref of the cross-entropy) and ``update_diff_f32`` (the update
compared before rounding to the leaf's dtype, over the leaves of
``update_diff``).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import torch

from bench import compare
from bench.reference import jamba as ref

CHECK_STEPS = 3
COUNTED_SHARE = 1e-3
PIECE = 1 << 26    # elements of a leaf worked at once on the device by the momentum check


def model_config(c: Dict):
    """The port's ``ModelConfig`` of a Jamba ``JambaConfig``'s keys."""
    from repro_torch.models.transformer import HybridConfig

    if c["model_type"] != "jamba":
        raise ValueError(f"lm_train runs Jamba configurations, not {c['model_type']!r}")
    rc = ref.config_from_json(c)
    P = c["attn_layer_period"]
    period = rc["kinds"][:P]
    if rc["kinds"] != period * (len(rc["kinds"]) // P) or c["num_hidden_layers"] % P:
        raise ValueError("the layers must be whole periods")
    held = tuple(rc["held"])
    return HybridConfig(
        name=c["name"], vocab=c["vocab_size"], d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], head_dim=rc["head_dim"], d_ff=c["intermediate_size"],
        pattern=tuple("mamba" if m == "mamba" else "global" for m, _ in period),
        slot_ffn=tuple("moe" if f == "moe" else "gated" for _, f in period),
        rope=False, causal_skip=True, n_experts=rc["n_experts"],
        top_k=c["num_experts_per_tok"], expert_d_ff=c["intermediate_size"],
        moe_dropless=True, moe_norm_topk=False, moe_aux_weight=c["router_aux_loss_coef"],
        moe_held=None if held == (0, rc["n_experts"]) else held,
        d_inner=rc["d_inner"], d_state=c["mamba_d_state"], mamba_norms=True,
        tied_embeddings=c["tie_word_embeddings"], norm="rms", activation=c["hidden_act"],
        dtype=c["dtype"])


def reference_names(named, n_period: int) -> Dict[str, tuple]:
    """Program leaf name (``tree_flatten_with_names``) -> (reference name,
    repeat index or None, whether the leaf is a unit-offset norm scale)."""
    leaf = {"ln1__scale": "ln1", "ln2__scale": "ln2", "mamba__a_log": "A_log",
            "mamba__d_skip": "D", "ffn__wi_gate": "gate", "ffn__wi_up": "up",
            "ffn__wo": "down", "ffn__router": "router"}
    out = {"embed__table": ("embed", None, False), "final_norm__scale": ("final_norm", None, True),
           "unembed": ("unembed", None, False)}
    for name, t in named:
        if not name.startswith("stack__"):
            continue
        _, slot, rest = name.split("__", 2)
        s = int(slot.split("_", 1)[0][1:])
        short = leaf.get(rest, rest.split("__", 1)[1])
        offset = rest.endswith("scale") or short.endswith("_norm")
        out[name] = [(f"{r * n_period + s}.{short}", r, offset) for r in range(t.shape[0])]
    return out


def host_leaves(params) -> Dict[str, torch.Tensor]:
    from repro_torch.tree import tree_flatten_with_names

    named, _ = tree_flatten_with_names(params)
    return {k: t.detach().cpu().clone() for k, t in named}


class AsReference(dict):
    """The reference's weights from the program's leaves, by reference
    name: each the leaf as it is (the reference moves it to the device in
    f32 when its layer runs), a norm's weight 1 + the program's scale,
    made when read (no f32 copy of the model on the host)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], names):
        super().__init__(_by_reference_name(leaves, names))
        self.offset = {rname for where in names.values()
                       for rname, _, off in (where if isinstance(where, list) else [where])
                       if off}

    def __getitem__(self, name):
        t = super().__getitem__(name)
        return t.float() + 1.0 if name in self.offset else t


def _by_reference_name(leaves: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """The program's leaves as they are (dtype kept), by reference name."""
    out = {}
    for k, t in leaves.items():
        where = names[k]
        for rname, r, _ in (where if isinstance(where, list) else [where]):
            out[rname] = t if r is None else t[r]
    return out


def worst_leaf(nums: Dict[str, tuple]) -> float:
    """max over the leaves of diff / max(ref_norm, the median ref_norm),
    ``nums``: name -> (diff, ref_norm)."""
    if not nums:
        return math.inf
    med = statistics.median(n for _, n in nums.values())
    worst = 0.0
    for d, n in nums.values():
        v = d / max(n, med)
        if not math.isfinite(v):
            return math.inf
        worst = max(worst, v)
    return worst


def entries_missed(x: torch.Tensor, y: torch.Tensor, eidx: torch.Tensor, gate: torch.Tensor,
                   experts, held) -> int:
    """What an MoE layer computed, read from what it gave out. ``x`` (T, d)
    its input, ``y`` (T, d) its output, ``eidx``/``gate`` (T, K) its
    router's choices and gates; ``experts(j, rows)`` the plain f32 output
    of held expert ``first + j``. Each token's ``y`` is fitted (least
    squares, f64) as ``sum_k c_k * gate_k * expert_k(x)`` over its held
    entries: an entry computed once reads ``c`` near 1, a dropped one near
    0, one computed twice near 2, one fed another token's row near 0.
    Returns the held entries with |c - 1| > 1/2, plus the tokens whose
    output leaves more than half its norm outside that fit (an output where
    no held entry asked for one); a number that is not finite counts."""
    first, stop = held
    T, K = eidx.shape
    x, y = x.float(), y.double()
    is_held = (eidx >= first) & (eidx < stop)
    O = torch.zeros((T, K, x.shape[1]), dtype=torch.float64, device=x.device)
    for j, e in enumerate(range(first, stop)):
        tok, k = torch.where(eidx == e)
        if tok.numel():
            O[tok, k] = (experts(j, x[tok]) * gate[tok, k, None].float()).double()
    G = torch.einsum("tkd,tjd->tkj", O, O)
    b = torch.einsum("tkd,td->tk", O, y)
    eye = torch.eye(K, dtype=G.dtype, device=G.device)
    free = ~is_held[:, :, None] | ~is_held[:, None, :]
    G = torch.where(free, eye.expand_as(G), G)     # an entry held elsewhere reads c = 0
    b = torch.where(is_held, b, torch.zeros_like(b))
    c = torch.linalg.solve(G, b)
    rest = (y - torch.einsum("tk,tkd->td", c, O)).norm(dim=-1)
    off = ~(rest <= 0.5 * y.norm(dim=-1))          # a NaN counts as missed
    return int((~((c - 1).abs() <= 0.5))[is_held].sum()) + int(off.sum())


class LmTrain:
    rate_metric = "train_samples_per_s"

    def __init__(self, ctx):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.transformer import PatternLM
        from repro_torch.tree import tree_flatten_with_names

        cfgj, tj = dict(ctx.cell.config), dict(ctx.cell.traffic)
        if ctx.toy:
            cfgj.update(cfgj["toy"])
            tj.update(tj["toy"])
        self.note, self.limits, self.device = ctx.note, ctx.cell.limits, ctx.device
        dev = ctx.device
        t0 = time.perf_counter()
        self.mcfg = model_config(cfgj)
        self.rcfg = ref.config_from_json(cfgj)
        opt = cfgj["optimizer"]
        self.lr, self.mu, self.wd = (float(opt[k]) for k in ("lr", "momentum", "weight_decay"))
        on_card = dev.type == "cuda"
        self.model = PatternLM(self.mcfg, seed=ctx.seed, device=dev, draw_on_device=on_card)
        self.params = self.model.params
        named, _ = tree_flatten_with_names(self.params)
        self.names = reference_names(named, len(self.mcfg.pattern))
        self.n_params = sum(t.numel() for _, t in named)
        ctx.note(f"set-up: {self.n_params:,} parameters drawn by {time.perf_counter() - t0:.2f} s")
        self.step, self.opt = make_train_step(
            self.model, lr=self.lr, momentum=self.mu, weight_decay=self.wd, inplace=True)
        self.opt_state = self.opt.init(self.params)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
        self.stream = ctx.cell.generator().make(tj, self.mcfg.vocab, gen, dev)
        self.batch = self.stream.batch
        self.steps_per_unit = 1
        self.n_moe = sum(f == "moe" for _, f in self.rcfg["kinds"])
        self.info = {"batch": self.batch, "seq": self.stream.seq,
                     "config": {k: cfgj[k] for k in (
                         "hidden_size", "intermediate_size", "num_attention_heads",
                         "num_key_value_heads", "vocab_size", "mamba_d_state", "mamba_dt_rank",
                         "mamba_expand", "mamba_d_conv", "num_experts_per_tok",
                         "num_hidden_layers", "attn_layer_period", "attn_layer_offset",
                         "expert_layer_period", "expert_layer_offset")},
                     "experts_held": list(self.rcfg["held"]), "router_experts": self.rcfg["n_experts"],
                     "n_params": self.n_params}
        self._first_steps()
        ctx.note(f"set-up: {CHECK_STEPS} steps run and kept by {time.perf_counter() - t0:.2f} s")

    def _batch(self):
        t = self.stream.draw()
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def _run(self, batch):
        self.params, self.opt_state, m = self.step(self.params, self.opt_state, batch, None)
        return m

    def _first_steps(self):
        """Steps 1-3, step 1 recorded and step 2's update checked (see the
        module's docstring)."""
        from repro_torch.models import mamba, moe

        self.p0 = host_leaves(self.params)
        routes, gates, layer_io, ys, grads = [], [], [], [], {}
        route_fn, scan_fn, dropless_fn = moe._route, mamba._ssm_chunked, moe._dropless_fwd

        def recorded_route(*args):
            probs, gate, eidx = route_fn(*args)
            if len(routes) < self.n_moe:
                routes.append(eidx.detach().cpu().clone())
                gates.append(gate.detach().float().cpu().clone())
            return probs, gate, eidx

        def recorded_moe(params, x, cfg, sp):
            y, aux = dropless_fn(params, x, cfg, sp)
            if len(layer_io) < self.n_moe:
                layer_io.append((x.detach().reshape(-1, x.shape[-1]).cpu().clone(),
                                 y.detach().reshape(-1, y.shape[-1]).cpu().clone()))
            return y, aux

        def recorded_scan(*args):
            y, h = scan_fn(*args)
            if not ys:
                ys.append(y.detach().float().cpu().clone())
            return y, h

        opt = self.opt

        def recorded_update(g, state, params, lr):
            grads.update(host_leaves(g))
            return type(opt).update(opt, g, state, params, lr)

        def checked_update(g, state, params, lr):
            params, state = type(opt).update(opt, g, state, params, lr)
            self.momentum_nums = self._momentum_numbers(g, params)
            return params, state

        batch = self._batch()
        self.tokens1 = {k: v.cpu() for k, v in batch.items()}
        moe._route, mamba._ssm_chunked = recorded_route, recorded_scan
        moe._dropless_fwd = recorded_moe
        object.__setattr__(opt, "update", recorded_update)
        try:
            m1 = self._run(batch)
        finally:
            moe._route, mamba._ssm_chunked, moe._dropless_fwd = route_fn, scan_fn, dropless_fn
            object.__delattr__(opt, "update")
        self.routes, self.gates, self.layer_io = routes, gates, layer_io
        self.y_prog, self.grads = (ys[0] if ys else None), grads
        self.p1 = host_leaves(self.params)
        self.momentum_nums = {}
        object.__setattr__(opt, "update", checked_update)
        try:
            m2 = self._run(self._batch())
        finally:
            object.__delattr__(opt, "update")
        losses = [m1["loss"], m2["loss"]] + [self._run(self._batch())["loss"]
                                             for _ in range(CHECK_STEPS - 2)]
        self.losses = [float(v) for v in losses]

    def _momentum_numbers(self, g2, p2) -> Dict[str, tuple]:
        """Per leaf (||p2 - e2||, ||e2 - p1||), e2 = p1 + (mu * v1 - lr * g2)
        rounded to the leaf's dtype, v1 = -lr * g1 (weight decay added to
        each gradient where the configuration has it); worked out on the
        device a piece at a time from the kept step-0/1 leaves and step 2's
        gradient ``g2`` and weights ``p2`` (the velocity starts at 0, so
        step 1 made it -lr * g1)."""
        from repro_torch.tree import tree_flatten_with_names

        g2n, _ = tree_flatten_with_names(g2)
        p2n = dict(tree_flatten_with_names(p2)[0])
        dev, lr, mu, wd = self.device, self.lr, self.mu, self.wd
        out = {}
        for name, g in g2n:
            p = p2n[name]
            p0, p1, g1 = (t.reshape(-1) for t in (self.p0[name], self.p1[name], self.grads[name]))
            d2, r2 = 0.0, 0.0
            for s in range(0, p1.numel(), PIECE):
                sl = slice(s, s + PIECE)
                p1c, g1c = p1[sl].to(dev), g1[sl].to(dev).float()
                g2c = g.reshape(-1)[sl].float()
                if wd:
                    g1c = g1c + wd * p0[sl].to(dev).float()
                    g2c = g2c + wd * p1c.float()
                v1 = -(lr * g1c)
                e2 = (p1c.float() + (mu * v1 - lr * g2c)).to(p1c.dtype).float()
                d2 += float((p.reshape(-1)[sl].float() - e2).double().square().sum())
                r2 += float((e2 - p1c.float()).double().square().sum())
            if r2 > 0:
                out[name] = (math.sqrt(d2), math.sqrt(r2))
        return out

    def measure(self, seconds, sub):
        """Whole steps for ``seconds``; the first is the profiled stretch."""
        w = {"work": 0, "attempted": 0}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        w["t_start"] = t0 = time.perf_counter()
        steps, ends = 0, []
        while True:
            if steps == 0:
                sub.begin()
            w["attempted"] += 1
            self._run(self._batch())
            steps += 1
            if steps == 1:
                sub.end(1, 1)
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        w["t_end"] = time.perf_counter()
        w["work"] = steps * self.batch
        self.info["window_steps"] = steps
        self.note("window steps (s): " + " ".join(
            f"{b - a:.4f}" for a, b in zip([t0] + ends, ends)))
        return w

    def free_program(self) -> None:
        self.model = self.params = self.opt_state = self.step = self.opt = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------------

    def _reference(self, precision: str, routes, on_grad):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w = AsReference(self.p0, self.names)
        return ref.loss_and_grads(w, self.tokens1["tokens"], self.tokens1["labels"], self.rcfg,
                                  device=self.device, precision=precision, routes=routes,
                                  on_grad=on_grad)

    def _compare(self, got: Dict, routes, grad_of, p1_of, y) -> Dict[str, float]:
        """The numbers of one side (its gradients ``grad_of(name)``, weights
        after step 1 ``p1_of(name)``, loss, scan output ``y`` and recorded
        routes) against the f32 reference routed by those routes."""
        dev = self.device
        p0 = _by_reference_name(self.p0, self.names)
        gnums, unums, fnums, rounding = {}, {}, {}, {}

        def on_grad(name, g):
            g = g.detach()
            gp = grad_of(name).to(dev).float()
            gnums[name] = (float((gp - g).double().norm()), float(g.double().norm()))
            base = p0[name].to(dev)
            r1 = (base.float() - self.lr * g).to(base.dtype).float()
            dr = float((r1 - base.float()).double().norm())
            if dr > 0:
                p1 = p1_of(name).to(dev).float()
                unums[name] = (float((p1 - r1).double().norm()), dr)
                fnums[name] = (self.lr * gnums[name][0], self.lr * gnums[name][1])
                # the look behind update_diff: elements whose stored update
                # differs, elements the update changed, and elements whose
                # f32 update is under half a step of the leaf's dtype there
                half_step = torch.finfo(base.dtype).eps / 2 * base.float().abs()
                rounding[name] = (int((p1 != r1).sum()), int((r1 != base.float()).sum()),
                                  int(((self.lr * g).abs() < half_step).sum()), base.numel())

        r = self._reference("f32", routes, on_grad)
        self.leaf_numbers = {"grad": gnums, "update": unums, "update_f32": fnums}
        self.rounding = rounding
        med = statistics.median(n for _, n in gnums.values())
        counted = {k: v for k, v in gnums.items() if v[1] >= COUNTED_SHARE * med}
        out = {"loss_gap.step1": abs(got["loss"] - r["loss"]) / abs(r["loss"])
               if math.isfinite(got["loss"]) else math.inf,
               "grad_diff": worst_leaf(counted), "update_diff": worst_leaf(unums),
               "update_diff_f32": worst_leaf(fnums),
               "momentum_diff": worst_leaf(self.momentum_nums)}
        yr = r.get("y0")
        if y is None or yr is None or y.shape != yr.shape:
            out["ssm_out_diff"] = math.inf
        else:
            out["ssm_out_diff"] = float((y.double() - yr.double()).norm() / yr.double().norm())
        entries, missed = 0, 0
        for p, o in zip(routes, r["own"]):
            same = (p[:, :, None] == o[:, None, :]).any(-1)
            entries += p.numel()
            missed += int((~same).sum())
        out["route_disagree"] = missed / entries if entries else math.inf
        return out

    def _rows_missed(self) -> float:
        """``moe_rows_missed`` of the program's step-1 MoE layers (see
        :func:`entries_missed`), each held expert the plain f32 SwiGLU of
        the step-0 weights."""
        if not (len(self.layer_io) == len(self.routes) == len(self.gates) == self.n_moe):
            return math.inf
        w = AsReference(self.p0, self.names)
        moe_layers = [i for i, (_, f) in enumerate(self.rcfg["kinds"]) if f == "moe"]
        missed = 0
        for i, (x, y), eidx, gate in zip(moe_layers, self.layer_io, self.routes, self.gates):
            def experts(j, rows, i=i):
                m = {k: w[f"{i}.{k}"][j].to(self.device, torch.float32)
                     for k in ("gate", "up", "down")}
                return ref.swiglu(rows, m["gate"], m["up"], m["down"], "f32")

            dev = self.device
            missed += entries_missed(x.to(dev), y.to(dev), eidx.to(dev), gate.to(dev),
                                     experts, self.rcfg["held"])
        return float(missed)

    def readings(self) -> Dict[str, float]:
        """Every number of the program against the reference, once the
        program's state is freed."""
        self.free_program()
        n_entries = self.tokens1["tokens"].numel() * self.rcfg["top_k"]
        if (len(self.routes) != self.n_moe or not self.grads
                or any(r.numel() != n_entries for r in self.routes)):
            # the step did not route this step's tokens: nothing to compare
            return {name: math.inf for name in self.limits}
        grads = _by_reference_name(self.grads, self.names)
        p1 = _by_reference_name(self.p1, self.names)
        out = self._compare({"loss": self.losses[0]}, self.routes, grads.__getitem__,
                            p1.__getitem__, self.y_prog)
        out["moe_rows_missed"] = self._rows_missed()
        self.note("check (no limit): loss_gap.step1 {:.3e}, update_diff_f32 {:.4f}".format(
            out["loss_gap.step1"], out["update_diff_f32"]))
        return out

    def control_readings(self, precision: str) -> Dict[str, float]:
        """The same numbers with the reference in ``precision`` put in the
        program's place (routing by its own choices, its weights after
        step 1 rounded as the program stores them; step 2's update and the
        MoE entries computed are the program's)."""
        self.free_program()
        p0 = _by_reference_name(self.p0, self.names)
        cg = {}

        def keep(name, g):
            cg[name] = g.detach().cpu()

        c = self._reference(precision, None, keep)
        routes = c["own"]
        p1 = {k: (p0[k].float() - self.lr * g).to(p0[k].dtype) for k, g in cg.items()}
        out = self._compare({"loss": c["loss"]}, routes, cg.__getitem__, p1.__getitem__,
                            c.get("y0"))
        out["moe_rows_missed"] = self._rows_missed()
        return out

    def check(self):
        return compare.judged(self.readings(), self.limits)


def build(ctx):
    return LmTrain(ctx)
