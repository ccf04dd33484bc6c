"""Faults planted in the timed path underneath, to show that the
comparison catches them: a step that returns its state unchanged; half of
the batch left out (the mean taken over the rest); the evaluation's answer
altered where it is made (its accuracy taken over half of the test rows;
its forward with All-ReLU's slopes of the wrong parity); a feed that
repeats rows (each epoch's second half a copy of its first,
so the rate would count samples that were never distinct). Each ``apply_*``
patches the program in place and returns the function that undoes it.
The tests (``tests/test_bench_faults.py``) and ``calibrate.py --fault``
use them; a benchmark run never does."""


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def apply_unchanged_state():
    from repro_torch.optim import sgd

    return _patch(sgd.MomentumSGD, "update",
                  lambda self, grads, state, params, lr: (params, state))


def apply_half_batch():
    from repro_torch.launch import steps
    from repro_torch.train import trainer

    make_core, grad = trainer.make_mlp_step_core, steps._microbatched_grad

    def halved_core(*args, **kwargs):
        core = make_core(*args, **kwargs)

        def step_core(p, s, inp, rng):
            idx, lr = inp
            return core(p, s, (idx[: max(1, idx.shape[0] // 2)], lr), rng)

        return step_core

    def halved_grad(loss_fn, params, batch, microbatches):
        half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return grad(loss_fn, params, half, microbatches)

    undo = [_patch(trainer, "make_mlp_step_core", halved_core),
            _patch(steps, "_microbatched_grad", halved_grad)]
    return lambda: [u() for u in undo]


def apply_eval_half():
    from repro_torch.train import trainer

    evaluate = trainer.evaluate

    def halved(model, x, y, *args, **kwargs):
        n = max(1, x.shape[0] // 2)
        return evaluate(model, x[:n], y[:n], *args, **kwargs)

    return _patch(trainer, "evaluate", halved)


def apply_eval_slope_flipped():
    import dataclasses

    from repro_torch.train import trainer

    forward = trainer.mlp_forward

    def flipped(params, topo, x, config, **kwargs):
        if not kwargs.get("train", False):
            config = dataclasses.replace(config, alpha=-config.alpha)
        return forward(params, topo, x, config, **kwargs)

    return _patch(trainer, "mlp_forward", flipped)


def apply_feed_repeated():
    from repro_torch.data.loader import ShardedLoader

    order = ShardedLoader.epoch_order

    def repeated(self, epoch):
        o = order(self, epoch).copy()
        half = o.size // 2
        o[half : 2 * half] = o[:half]
        return o

    return _patch(ShardedLoader, "epoch_order", repeated)


FAULTS = {"unchanged_state": apply_unchanged_state, "half_batch": apply_half_batch,
          "eval_half": apply_eval_half, "eval_slope_flipped": apply_eval_slope_flipped,
          "feed_repeated": apply_feed_repeated}
