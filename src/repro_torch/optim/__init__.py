"""Optimizers: AdamW (``adamw``), int8 gradient compression with its
error-feedback psum (``compress``) and ZeRO-1 over a mesh axis
(``zero1``, inside ``parallel.spmd.shard_map``)."""
