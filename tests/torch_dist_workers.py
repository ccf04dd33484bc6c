"""Rank functions for the port's multi-rank CPU tests (``gloo``), spawned
with :func:`spawn`: each rank joins a ``FileStore`` group, runs its part,
and rank 0 writes what it found as JSON. Imports neither JAX nor the
reference, so a spawned rank starts quickly."""
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world: int, *args) -> dict:
    """Run ``fn(rank, *args, out)`` on ``world`` gloo ranks; rank 0's JSON.
    The group is torn down in every rank."""
    with tempfile.TemporaryDirectory(prefix="torch_dist_") as d:
        out = os.path.join(d, "out.json")
        mp.spawn(_entry, args=(world, os.path.join(d, "store"), fn, args, out), nprocs=world)
        with open(out) as f:
            return json.load(f)


def _entry(rank, world, store, fn, args, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def drive(rank, mesh, per_replica_batch, ckpt_dir, steps=4):
    """``run_training`` on a (data, model) mesh; the losses, and every
    parameter's local shape and global shape as the step saw them."""
    from repro_torch.launch import train

    seen = {}
    real = train.make_sharded_train_step

    def spy(model, mesh_, layouts, **kw):
        step, opt = real(model, mesh_, layouts, **kw)

        def wrapped(params, *a):
            from repro_torch.tree import tree_flatten_with_names

            for name, t in tree_flatten_with_names(params)[0]:
                seen[name] = [list(t.to_local().shape), list(t.shape),
                              [str(p) for p in t.placements]]
            return step(params, *a)

        return wrapped, opt

    train.make_sharded_train_step = spy
    hist = train.run_training(train.DriverConfig(
        steps=steps, seq=16, per_replica_batch=per_replica_batch, mesh_data=mesh[0],
        mesh_model=mesh[1], save_every=2, ckpt_dir=ckpt_dir, verbose=False, device="cpu"))
    return {"loss": hist["loss"], "leaves": seen}


def sharded_step(rank):
    """The twin of the reference's sharded train step on a host mesh: the
    SMOKE Qwen1.5 on a 2 x 1 mesh, batch 4, one step."""
    from repro_torch import configs
    from repro_torch.launch.axes import logical_axis_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import default_rules, shape_aware_shardings
    from repro_torch.launch.train import make_sharded_train_step, shard_tree
    from repro_torch.models.transformer import PatternLM
    from repro_torch.optim.sgd import SGDState

    mesh = make_debug_mesh(2, 1, device="cpu")
    model = PatternLM(configs.get_spec("qwen1.5-0.5b").smoke, seed=0, device="cpu")
    rules = default_rules(mesh, batch_size=4)
    param_sh = shape_aware_shardings(rules, model.specs, model.params)
    step_fn, opt = make_sharded_train_step(model, mesh, param_sh, lr=0.01)
    opt_state = opt.init(model.params)
    opt_state = SGDState(shard_tree(opt_state.velocity, param_sh), opt_state.step)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long),
             "labels": torch.zeros((2, 16), dtype=torch.long)}
    with logical_axis_rules(rules):
        params = shard_tree(model.params, param_sh)
        params, opt_state, metrics = step_fn(params, opt_state, batch, model.topo_arrays())
    return {"loss": float(metrics["loss"]),
            "table": [list(params["embed"]["table"].to_local().shape),
                      [str(p) for p in params["embed"]["table"].placements]]}


def wasap_shard_map(rank, n_workers, dropout):
    """The phase-1 epoch with ``worker_axis="shard_map"`` on the worker
    mesh against ``"vmap"`` on the same rank, from one seed: whether every
    param, velocity, loss and the generator's state are bit-equal."""
    from repro_torch.core import wasap as tw
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
    from repro_torch.optim.sgd import MomentumSGD
    from repro_torch.tree import tree_leaves

    rng = np.random.default_rng(0)
    n, f, c, h, b, rounds = 64, 12, 4, 2, 4, 2
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, c, n)).long()
    cfg = SparseMLPConfig(layer_dims=(f, 8, c), epsilon=6, dropout=dropout, impl="element")
    model = SparseMLP(cfg, seed=0, device="cpu")
    opt = MomentumSGD(momentum=0.9, weight_decay=1e-4)
    idx = torch.from_numpy(rng.integers(0, n, (rounds, n_workers, h, b))).long()
    lrs = torch.full((rounds, h), 0.05)
    valid = torch.ones((rounds, h))
    valid[-1, -1] = 0.0  # a padded tail step
    runs = []
    mesh = make_worker_mesh(n_workers, device="cpu")
    for axis in ("vmap", "shard_map"):
        key = torch.Generator()
        key.manual_seed(7)
        params = model.params()
        epoch = tw.make_phase1_epoch_fn(cfg, opt, n_workers=n_workers, worker_axis=axis,
                                        mesh=mesh if axis == "shard_map" else None, donate=())
        runs.append(tree_leaves(epoch(params, opt.init(params), model.topo_arrays(), x, y, idx,
                                      lrs, valid, key)) + [key.get_state()])
    mesh_data = mesh.size(0)
    equal = len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))
    all_ok = [torch.zeros(1, dtype=torch.long) for _ in range(dist.get_world_size())]
    dist.all_gather(all_ok, torch.tensor([int(equal)]))
    return {"equal_on_every_rank": [int(t) for t in all_ok], "mesh_data": mesh_data}


def restore_onto_mesh(rank, ckpt_dir):
    """A checkpoint of full leaves restored onto a 2 x 1 mesh's shardings:
    every leaf a DTensor whose local shard is this rank's slice of the
    saved leaf (rank 0 reports both ranks' by an all-gather)."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import default_rules, shape_aware_shardings
    from repro_torch.models.transformer import PatternLM
    from repro_torch.tree import tree_flatten_with_names

    mesh = make_debug_mesh(2, 1, device="cpu")
    model = PatternLM(configs.get_spec("qwen1.5-0.5b").smoke, seed=0, device="cpu")
    layouts = shape_aware_shardings(default_rules(mesh, batch_size=2), model.specs, model.params)
    mgr = CheckpointManager(ckpt_dir)
    if rank == 0:
        mgr.save(3, model.params, meta={"arch": "qwen1.5-0.5b"})
        mgr.wait()
    dist.barrier()
    params, _, _, manifest = mgr.restore(step=3, like=model.params, shardings=layouts)
    ok, sharded = True, 0
    full = dict(tree_flatten_with_names(model.params)[0])
    for name, t in tree_flatten_with_names(params)[0]:
        local = t.to_local()
        ok &= torch.equal(layouts_of(layouts, name).shard(full[name]), local)
        ok &= torch.equal(t.full_tensor(), full[name])
        sharded += int(local.numel() < full[name].numel())
    flags = [torch.zeros(1, dtype=torch.long) for _ in range(2)]
    dist.all_gather(flags, torch.tensor([int(ok)]))
    return {"ok": [int(f) for f in flags], "sharded_leaves": sharded,
            "step": manifest["step"], "n_leaves": len(full)}


def layouts_of(layouts, name):
    from repro_torch.tree import tree_flatten_with_names

    return dict(tree_flatten_with_names(layouts)[0])[name]
