"""The plain reference of a layered hybrid LM with a MoE in every layer
(granite-4.0-h-small's ``granitemoehybrid`` layout as the configuration
states it), written from the published equations:

* the embeddings times ``embedding_multiplier``;
* each layer, its mixer given by ``layer_types``:
  ``h = x + r * mixer(rmsnorm(x))``, then
  ``y = h + r * (moe(rmsnorm(h)) + shared(rmsnorm(h)))``, with ``r`` the
  ``residual_multiplier`` and every norm's eps ``norm_eps``;
* a Mamba2 mixer: ``in_proj`` split as z | x | B | C | dt, a causal
  depthwise conv over x | B | C plus its bias, SiLU; ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head the state
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T`` read out as ``y_t = h_t
  C_t``, plus ``D x_t``; then ``rmsnorm(y * silu(z))`` over all the inner
  channels (one group) and ``out_proj``;
* an attention mixer: grouped-query attention without positions (NoPE),
  its scores scaled by ``attention_multiplier``, causal;
* the MoE: ``moe_lm``'s routing and bounded capacity (each call of the
  layer a group of tokens), and the always-on shared SiLU-GLU expert;
* the logits: the final rmsnorm against the tied embedding, divided by
  ``logits_scaling``.

The state-space recurrence is computed in its chunked dual form: within a
block of positions, the masked matrix of decays between every pair of
positions, times C.B and dt; across blocks, the state carried from the
block before.  Float32 from the benchmark's weights, a layer at a time;
nothing here imports the program."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import common, moe_lm

# positions in a block of the state-space recurrence's dual form
BLOCK = 128


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """y (B, T, H, P) of the selective state space: x (B, T, H, P), dt
    (B, T, H), A (H,), Bm and Cm (B, T, N), the state (B, H, P, N) zero
    before the first position."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    out = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    for s0 in range(0, t, block):
        s1 = min(t, s0 + block)
        xs, ds, bs, cs = x[:, s0:s1], dt[:, s0:s1], Bm[:, s0:s1], Cm[:, s0:s1]
        # l[i]: the log of the decay from the block's start to position i
        l = torch.cumsum(ds * A, dim=1).permute(0, 2, 1)                 # (B, H, L)
        pos = torch.arange(s1 - s0, device=x.device)
        ahead = pos[None, :] > pos[:, None]                              # s after t
        gap = (l[..., :, None] - l[..., None, :]).masked_fill(ahead, float("-inf"))
        cb = torch.einsum("btn,bsn->bts", cs, bs)                        # (B, L, L)
        weight = torch.exp(gap) * cb[:, None] * ds.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhts,bshp->bthp", weight, xs)
        y = y + torch.einsum("bhpn,btn->bthp", state, cs) * torch.exp(l).permute(0, 2, 1)[..., None]
        out[:, s0:s1] = y
        # the state at the block's end
        to_end = torch.exp(l[..., -1:] - l) * ds.permute(0, 2, 1)        # (B, H, L)
        state = (torch.exp(l[..., -1])[..., None, None] * state
                 + torch.einsum("bhs,bshp,bsn->bhpn", to_end, xs, bs))
    return out


def mamba2(x: torch.Tensor, p, cfg, mm: common.Products) -> torch.Tensor:
    """One Mamba2 mixer on the normed x (B, T, d)."""
    b, t, d = x.shape
    sc = cfg["ssm"]
    inner = sc["expand"] * d
    heads, hd, n, width = sc["n_ssm_heads"], sc["head_dim"], sc["d_state"], sc["conv_width"]
    z, xbc, dt = torch.split(mm(x, p["in_proj"]), [inner, inner + 2 * n, heads], dim=-1)
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    w = p["conv_w"].float()
    conv = sum(padded[:, i: i + t] * w[i] for i in range(width))
    if sc.get("conv_bias"):
        conv = conv + p["conv_bias"].float()
    xs, Bm, Cm = torch.split(F.silu(conv), [inner, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xs = xs.reshape(b, t, heads, hd)
    y = ssd(xs, dt, A, Bm, Cm) + p["D"].float()[:, None] * xs
    g = common.rmsnorm(y.reshape(b, t, inner) * F.silu(z), p["norm_scale"], cfg["norm_eps"])
    return mm(g, p["out_proj"])


def attention(x: torch.Tensor, p, cfg, mm: common.Products, rows: int = 256) -> torch.Tensor:
    """Causal grouped-query attention without positions on the normed x
    (B, T, d), scores scaled by ``attention_multiplier``; queries in
    blocks of ``rows``."""
    b, t, _ = x.shape
    h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
    hd = int(cfg.get("head_dim") or cfg["d_model"] // h)
    g = h // kvh
    q = mm(x, p["wq"]).view(b, t, kvh, g, hd)
    k = mm(x, p["wk"]).view(b, t, kvh, hd)
    v = mm(x, p["wv"]).view(b, t, kvh, hd)
    out = torch.empty((b, t, kvh, g, hd), dtype=torch.float32, device=x.device)
    keys = torch.arange(t, device=x.device)
    for s0 in range(0, t, rows):
        s1 = min(t, s0 + rows)
        scores = torch.einsum("bskgd,btkd->bkgst", q[:, s0:s1], k) * cfg["attention_multiplier"]
        later = keys[None, :] > torch.arange(s0, s1, device=x.device)[:, None]
        probs = torch.softmax(scores.masked_fill(later, float("-inf")), dim=-1)
        out[:, s0:s1] = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return mm(out.reshape(b, t, h * hd), p["wo"])


def logits_at(w, cfg, tokens: torch.Tensor, at: torch.Tensor, *, groups=None,
              fp8: bool = False) -> torch.Tensor:
    """Logits (N, vocab) at the positions ``at`` (N, 2: row, column) of a
    causal forward over ``tokens`` (B, T); ``groups`` lists the column
    ranges that were one call of the model (the prefill, then each decode
    step), all columns one call when None."""
    mm = common.Products(fp8)
    eps, r = cfg["norm_eps"], cfg["residual_multiplier"]
    groups = groups or [(0, tokens.shape[1])]
    blocks = w["blocks"]
    x = w["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        j = seen[kind]
        seen[kind] += 1
        xn = common.rmsnorm(x, blocks["ln1"]["scale"][i], eps)
        if kind == "mamba":
            x = x + r * mamba2(xn, common.layer_of(blocks["mamba"], j), cfg, mm)
        else:
            x = x + r * attention(xn, common.layer_of(blocks["attn"], j), cfg, mm)
        p = common.layer_of(blocks["moe"], i)
        xn = common.rmsnorm(x, blocks["ln2"]["scale"][i], eps)
        sh = p["shared"]
        x = x + r * (moe_lm.moe_layer(xn, p, cfg, groups, mm)
                     + common.glu(xn, sh["w_gate"], sh["w_up"], sh["w_down"], mm))
    xn = common.rmsnorm(x[at[:, 0], at[:, 1]], w["final_norm"]["scale"], eps)
    return mm(xn, w["embed"].t())[:, : cfg["vocab"]] / cfg["logits_scaling"]

