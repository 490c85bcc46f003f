"""Public wrapper for flash attention."""
from .kernel import choose_block_sizes, flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "choose_block_sizes"]
