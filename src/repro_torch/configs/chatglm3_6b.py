"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (rotary on half the head dims), GQA
[arXiv:2406.12793; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    act="silu_glu",
    rope="half",
    source="[arXiv:2406.12793; hf]",
)
