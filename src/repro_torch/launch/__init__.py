"""Launch-time helpers (the twin of the JAX package's ``launch/``):
:mod:`.mesh`, the production and test mesh builders.  ``dryrun.py``,
``hlo_stats.py`` and ``roofline.py`` come after the next multi-device
slice (ROADMAP A10)."""
