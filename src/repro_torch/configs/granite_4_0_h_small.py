"""granite-4.0-h-small [layered]: 40L d_model=4096, 36 Mamba2 layers and 4
GQA attention layers (32H, kv=8, NoPE) at layers 5, 15, 25 and 35, each
mixer followed by a MoE of 72 experts top-10 (width 768) and a shared
expert (width 1536); vocab=100352, tied embeddings
[hf:ibm-granite/granite-4.0-h-small; hf].

The JAX package has no such model, so this configuration is not in the
registry, whose names mirror the JAX package's: import ``CONFIG`` from
this module."""
from .base import ArchConfig, MoECfg, SSMCfg

MAMBA, ATTENTION = "mamba", "attention"

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="layered",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    head_dim=128,
    act="silu_glu",
    rope="none",
    moe=MoECfg(n_experts=72, top_k=10, d_ff_expert=768, d_ff_shared=1536),
    ssm=SSMCfg(d_state=128, n_ssm_heads=128, head_dim=64, expand=2, conv_width=4,
               conv_bias=True),
    tie_embeddings=True,
    layer_types=tuple(ATTENTION if i % 10 == 5 else MAMBA for i in range(40)),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    norm_eps=1e-5,
    source="[hf:ibm-granite/granite-4.0-h-small; hf]",
)
