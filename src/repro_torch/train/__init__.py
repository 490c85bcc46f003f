"""Training: atomic checkpoints (``checkpoint``) and the fault-tolerant
``Trainer`` (``loop``)."""
