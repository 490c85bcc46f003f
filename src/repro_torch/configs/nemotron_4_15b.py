"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU [arXiv:2402.16819; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="relu2",
    norm="layernorm",
    rope="half",          # nemotron uses partial rotary
    source="[arXiv:2402.16819; unverified]",
)
