"""The runtime: crash recovery and fault tolerance. Twin of the reference's
``repro.runtime`` modules.

* ``runtime.donation``    — the buffer-donation policy and its meaning in
  PyTorch (donated: the callee may write the caller's buffers in place).
* ``runtime.faultinject`` — seeded, replayable faults: ``SIGKILL`` at a
  step, four checkpoint corruptions, transient step faults, suppressed
  heartbeats and the serving engine's chaos hook.
* ``runtime.supervisor``  — the recovery loop ``run_supervised``, its
  progress file, ``retry_step``, the heartbeat monitor and the elastic mesh
  plan; ``python -m repro_torch.runtime.supervisor`` is a small supervised
  SET-MLP run.
"""
