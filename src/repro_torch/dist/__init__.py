"""Sharding rules and the distributed substrates on ``torch.distributed``
(port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — logical-axis -> mesh-dim resolution
  (``spec_for_shape``, the rules tables, DTensor ``placements``), the
  ``constrain`` activation anchor, and ``DeviceMesh`` construction over
  the running process group (a world-size-1 group is started in process
  when none runs).
* :mod:`repro_torch.dist.knn` — the sharded BrePartition search
  (``shard_index`` / ``distributed_knn``).
* :mod:`repro_torch.dist.collective_matmul` — ring all-gather /
  reduce-scatter matmuls.
* :mod:`repro_torch.dist.compression` — int8 gradient compression with
  error feedback.
* :mod:`repro_torch.dist.pipeline` — the GPipe microbatch schedule over a
  mesh dim.

The reference's ``compat`` module (forward-compat aliases of jax's API)
has no counterpart on purpose.
"""
