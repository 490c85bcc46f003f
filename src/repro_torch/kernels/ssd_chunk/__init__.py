"""Mamba2's SSD chunk scan: a wrapper over ``mlstm_chunk.chunked_gla``."""
from .ops import ssd_chunk, ssd_ref

__all__ = ["ssd_chunk", "ssd_ref"]
