"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    act="silu_glu",
    qk_norm=True,
    rope="full",
    rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768),
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
