"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
ssm_state=64 — Mamba2 backbone + shared attention block applied every 6
layers (weights shared, distinct KV caches) [arXiv:2411.15242; hf]."""
from .base import ArchConfig, HybridCfg, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    act="gelu_glu",
    rope="full",   # zamba2's shared attention block uses rotary embeddings
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_width=4),
    hybrid=HybridCfg(shared_attn_every=6),
    source="[arXiv:2411.15242; hf]",
)
