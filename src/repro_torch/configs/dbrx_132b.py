"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    act="silu_glu",
    norm="layernorm",
    rope="full",
    moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752),
    source="[hf:databricks/dbrx-base; unverified]",
)
