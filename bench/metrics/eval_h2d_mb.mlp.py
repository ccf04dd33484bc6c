"""The host bytes an epoch's evaluation hands to the card, in MB (1e6 B):
the mean ``h2d_bytes`` of the ``train.evaluate`` spans that
``eval_ms.mlp`` reads (the test set's slices, copied from pageable
memory), epochs 0 and 1 left out. Silent where the program has no such
span or counts no bytes in it."""


def read(tr):
    epochs = {s["id"] for s in tr.spans
              if s["name"] == "train.epoch" and s["attrs"].get("epoch", 0) > 1}
    counts = [s["attrs"]["h2d_bytes"] for s in tr.spans
              if s["name"] == "train.evaluate" and s["parent"] in epochs
              and "h2d_bytes" in s["attrs"]]
    if not counts:
        return None
    return sum(counts) / len(counts) / 1e6
