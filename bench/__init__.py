"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line. Everything a cell needs is
found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.json`` (read by the generator it names),
``runners/<runner>.py``, ``metrics/<metric>.py`` and ``counts/<kernel>.py``.
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
