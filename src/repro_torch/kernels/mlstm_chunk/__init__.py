"""Chunkwise gated linear attention (xLSTM's mLSTM; Mamba2's SSD rides on
it): the CUDA kernel ``csrc/gla.cu`` behind ``chunked_gla``."""
from .ops import choose_chunk, chunked_gla, gla_ref, mlstm_chunk, mlstm_ref

__all__ = ["chunked_gla", "mlstm_chunk", "gla_ref", "mlstm_ref", "choose_chunk"]
