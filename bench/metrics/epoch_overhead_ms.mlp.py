"""An epoch's time outside its fused segment: each window epoch's
``train.epoch`` span minus its ``train.segment`` span (the epoch's
permutation and learning rates, the topology phase, the wait for the
losses, the evaluation with its test-set uploads), the mean over the
traced window's epochs, in ms. Both are the port's spans; a span's close
waits for the device. Epoch 0 is the set-up's warm-up and epoch 1 the
profiled one (the capture's stop is in it): both are left out."""


def read(tr):
    epochs = {s["id"]: s for s in tr.spans
              if s["name"] == "train.epoch" and s["attrs"].get("epoch", 0) > 1}
    gaps = [epochs[s["parent"]]["dur_s"] - s["dur_s"] for s in tr.spans
            if s["name"] == "train.segment" and s["parent"] in epochs]
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
