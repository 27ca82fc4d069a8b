"""Distributed search on ``torch.distributed`` (port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — ``make_mesh``: a named
  ``DeviceMesh`` over the ranks of the running process group (a
  world-size-1 group is started in process when none runs).
* :mod:`repro_torch.dist.knn` — the sharded BrePartition search
  (``shard_index`` / ``distributed_knn``).
"""
