"""An epoch's evaluation: the mean ``dur_s`` of the port's
``train.evaluate`` spans (``train.trainer.evaluate``: the test set's
uploads, A's forward over it and the accuracy's read) in the window's
epochs, in ms. Epoch 0 is the set-up's warm-up and epoch 1 the profiled
one: both are left out. Silent where the program has no such span."""


def read(tr):
    epochs = {s["id"] for s in tr.spans
              if s["name"] == "train.epoch" and s["attrs"].get("epoch", 0) > 1}
    spans = [s for s in tr.spans if s["name"] == "train.evaluate" and s["parent"] in epochs]
    if not spans:
        return None
    return 1e3 * sum(s["dur_s"] for s in spans) / len(spans)
