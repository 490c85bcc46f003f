"""Multi-device execution (the twin of the JAX package's ``parallel/``).

* :mod:`.spmd` — ``Mesh``, ``shard_map`` and the collectives, run as one
  thread per rank in one process (the port's twin of what JAX provides);
* :mod:`.compat` — ``axis_size`` inside ``shard_map`` and under an
  ambient mesh;
* :mod:`.collective_matmul` — the ring all-gather and reduce-scatter
  matmuls;
* :mod:`.sp_attention` — sequence-parallel decode attention;
* :mod:`.pipeline` — GPipe-style pipeline parallelism.

``sharding.py`` and ``constrain.py`` (what the JAX package leaves to
GSPMD) come with the next multi-device slice (ROADMAP A9b).
"""
