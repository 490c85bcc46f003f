"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only: the speech frontend is a stub — ``input_specs()`` provides
precomputed frame embeddings fed to the encoder; the decoder decodes text
with cross-attention.  vocab 256206 padded to 256256."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,          # decoder layers
    n_enc_layers=24,      # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    act="relu2",          # conformer-ish FFN; squared relu stand-in for swish-glu-free
    norm="layernorm",
    # seamless uses learned/relative positions; RoPE is the length-safe
    # TPU-framework stand-in (documented adaptation in DESIGN.md)
    rope="full",
    enc_dec=True,
    frontend="frames",
    frontend_len=0,       # frames take the full encoder length
    source="[arXiv:2308.11596; hf]",
)
