"""Public wrappers for chunked gated linear attention / mLSTM."""
from .kernel import choose_chunk, chunked_gla, mlstm_chunk
from .ref import gla_ref, mlstm_ref

__all__ = ["chunked_gla", "mlstm_chunk", "gla_ref", "mlstm_ref", "choose_chunk"]
