"""The plain reference of a dense decoder-only LM (chatglm3-6b's layout
as the configuration states it): pre-norm RMSNorm blocks, grouped-query
attention with rotary embeddings, a SiLU-gated MLP, an untied LM head.
Float32 from the benchmark's weights, a layer at a time; no cache, no
batching: one causal forward over each sequence."""
from __future__ import annotations

import torch

from bench.reference import common


def logits_at(w, cfg, tokens: torch.Tensor, at: torch.Tensor, *, groups=None,
              fp8: bool = False) -> torch.Tensor:
    """Logits (N, vocab) at the positions ``at`` (N, 2: row, column) of a
    causal forward over ``tokens`` (B, T).  ``groups`` is the MoE's, and
    unused here."""
    mm = common.Products(fp8)
    hd = int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])
    x = w["embed"][tokens.long()].float()
    pos = common.positions_of(tokens.shape[1], x.device)
    for i in range(cfg["n_layers"]):
        p = common.layer_of(w["blocks"], i)
        x = x + common.attention_block(common.rmsnorm(x, p["ln1"]["scale"]), p["attn"],
                                       cfg, pos, mm, hd)
        m = p["mlp"]
        x = x + common.glu(common.rmsnorm(x, p["ln2"]["scale"]), m["w_gate"], m["w_up"],
                           m["w_down"], mm)
    return common.lm_head(w, cfg, x[at[:, 0], at[:, 1]], mm)
