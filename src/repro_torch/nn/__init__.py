"""Neural-network building blocks (plain functions on tensors; parameters
are dicts of tensors).  Only what the serving engine needs is ported."""
