"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].

The assignment specifies the transformer BACKBONE only: the InternViT
frontend is a stub — ``input_specs()`` provides precomputed patch
embeddings (frontend_len tokens of d_model) prepended to the text
sequence.  vocab 92553 is padded to 92672 (multiple of 256) for clean TP
sharding."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    act="silu_glu",
    rope="full",
    frontend="patches",
    frontend_len=256,
    source="[arXiv:2404.16821; hf]",
)
