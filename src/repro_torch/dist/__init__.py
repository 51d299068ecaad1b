"""Distribution layer for the memory pools (port of ``repro.dist``'s
recsys part): the pool and the D' store sharded over a 'model' axis of P
ranks, one process per rank.

  context         the ``Mesh`` (axis sizes, this rank, its device and the
                  'model' process group) and thread-local ``use_mesh``
  collectives     psum / all_gather / all_to_all / ppermute over the
                  'model' group, host-staged under gloo; ``run_ranks``
  exchange        the psum | ring | all_to_all strategies and their cost
                  model
  sharding        the row-split rules: a rank's slab, the padded store rows
  sharded_memory  the sharded lookups and sparse updates on a rank's slab

The reference runs each sharded lookup as a ``shard_map`` body over global
arrays; here every rank is a process that holds only its slab and store
rows and runs that body itself.  Only a 'data' axis of 1 is ported: every
rank sees the whole batch.
"""
