"""Launch-time helpers (the twin of the JAX package's ``launch/``):
:mod:`.mesh`, the production and test mesh builders; :mod:`.dryrun`, the
sharded step of every (architecture x input shape) cell traced on a mesh
of ``meta`` devices (rank 0 alone by default), with its memory, FLOPs and
collectives; :mod:`.roofline`, the three roofline terms of each row under
the H100's data-sheet figures; :mod:`.hlo_stats`, a copy of the
reference's HLO collective parser, for setting its rows beside the
port's."""
