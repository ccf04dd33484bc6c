"""The run's upload at its start: the ``dur_s`` of the port's first
``train.prepare`` span (``SequentialTrainer._prepare``: the training set
from pageable memory and the topology's device arrays, made on the host),
in s. It is part of set-up. Silent where the program has no such span."""


def read(tr):
    spans = [s for s in tr.spans if s["name"] == "train.prepare"]
    if not spans:
        return None
    return min(spans, key=lambda s: s["t0"])["dur_s"]
