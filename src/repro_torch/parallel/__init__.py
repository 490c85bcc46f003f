"""Multi-device execution (the twin of the JAX package's ``parallel/``).

* :mod:`.spmd` — ``Mesh``, ``shard_map`` and the collectives, run as one
  thread per rank in one process (the port's twin of what JAX provides);
* :mod:`.compat` — ``axis_size`` inside ``shard_map`` and under an
  ambient mesh;
* :mod:`.collective_matmul` — the ring all-gather and reduce-scatter
  matmuls;
* :mod:`.sp_attention` — sequence-parallel decode attention;
* :mod:`.pipeline` — GPipe-style pipeline parallelism;
* :mod:`.sharding` — the partition specs of params, optimizer state,
  batches and caches (a copy of the reference's rules), and their
  placement: each leaf cut once into per-rank shards;
* :mod:`.constrain` — ``constrain``: the identity off a mesh, a check of
  the rank's value inside ``shard_map``;
* :mod:`.sharded` — the LM family's train, prefill and decode steps with
  their collectives placed by hand (what the JAX package leaves to
  GSPMD).
"""
