"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517; unverified].  xLSTM[7:1]-style: sLSTM at layers
5 and 11, mLSTM elsewhere; no separate FFN (d_ff=0) — the blocks carry
their own up/down projections."""
from .base import ArchConfig, XLSTMCfg

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    rope="none",
    xlstm=XLSTMCfg(slstm_at=(5, 11), n_heads=4),
    tie_embeddings=True,
    source="[arXiv:2405.04517; unverified]",
)
