"""Flash attention forward (GQA, causal or full): the CUDA kernel
``csrc/flash_attention.cu`` behind ``flash_attention``, its block sizes
from the Stripe autotiler under ``h100``."""
from .ops import attention_ref, choose_block_sizes, flash_attention

__all__ = ["flash_attention", "attention_ref", "choose_block_sizes"]
