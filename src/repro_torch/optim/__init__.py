"""Optimizers: AdamW (``adamw``) and int8 gradient compression
(``compress``).  ``zero1`` (ZeRO-1 over a mesh) waits for the
multi-device slice (ROADMAP A9)."""
