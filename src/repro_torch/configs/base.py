"""Architecture configuration schema + input-shape specs.

Every assigned architecture is a frozen ``ArchConfig`` in its own module;
``registry.get(name)`` returns it and ``ArchConfig.scaled()`` produces the
reduced smoke-test variant.  Input shapes (train_4k / prefill_32k /
decode_32k / long_500k) are ``ShapeSpec``\\ s shared across archs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    d_ff_shared: int = 0      # an always-on shared GLU expert of this width (0: none)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    n_ssm_heads: int = 0      # 0 => d_model // head_dim-like default
    head_dim: int = 64        # channels per SSD head
    expand: int = 2
    conv_width: int = 4
    conv_bias: bool = False   # the causal conv adds a bias per channel


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_at: Tuple[int, ...] = ()   # layer indices using sLSTM blocks
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4
    n_heads: int = 4


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    shared_attn_every: int = 6  # a shared transformer block every k layers


def _nested(kind, value: Dict[str, Any]):
    return kind(**{k: tuple(v) if isinstance(v, list) else v for k, v in value.items()})


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | layered | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    act: str = "silu_glu"        # silu_glu | gelu_glu | relu2 | gelu
    norm: str = "rmsnorm"
    qk_norm: bool = False
    rope: str = "full"           # full | half | none
    rope_theta: float = 10_000.0
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    hybrid: Optional[HybridCfg] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"       # none | patches | frames (stub embeddings)
    frontend_len: int = 0        # patches/frames prepended / encoded
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"
    source: str = ""             # provenance note "[arXiv:...; tier]"
    # read by the layered family alone (``models/layered.py``), and refused
    # elsewhere unless at their defaults: each layer's mixer, "mamba" or
    # "attention", each followed by the MoE
    layer_types: Tuple[str, ...] = ()
    embedding_multiplier: float = 1.0   # the embeddings are scaled by it
    residual_multiplier: float = 1.0    # each residual branch is scaled by it
    logits_scaling: float = 1.0         # the logits are divided by it
    attention_multiplier: float = 0.0   # the softmax scale; 0 => 1 / sqrt(head dim)
    norm_eps: float = 1e-6              # every norm's, its Mamba2 gated norms' too

    def __post_init__(self):
        """Nested settings may come as mappings and sequences as lists (a
        configuration read from JSON); both become what the fields hold.
        Another family than the layered one refuses a layered setting
        away from its default: no path of it would read the value."""
        for name, kind in _NESTED.items():
            value = getattr(self, name)
            if isinstance(value, dict):
                object.__setattr__(self, name, _nested(kind, value))
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.family != "layered":
            unread = [f.name for f in dataclasses.fields(self)
                      if f.name in _LAYERED_ONLY and getattr(self, f.name) != f.default]
            if unread:
                raise ValueError(f"{self.name}: {', '.join(unread)} read only by the layered "
                                 f"family, not by {self.family!r}")

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM/hybrid/linear-attn)"""
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True  # all assigned archs have decoders (seamless is enc-dec)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6 N D."""
        d = self.d_model
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.hd
        # attention
        per_layer += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.moe:
            per_layer += d * self.moe.n_experts * self.moe.d_ff_expert * 3 + d * self.moe.n_experts
        elif self.d_ff:
            mult = 3 if self.act.endswith("_glu") else 2
            per_layer += mult * d * self.d_ff
        if self.family == "ssm" and self.xlstm:
            per_layer = int(2 * d * d * self.xlstm.proj_factor_mlstm * 2.2)
        if self.family == "hybrid" and self.ssm:
            inner = self.ssm.expand * d
            per_layer = 2 * d * inner + inner * d + 2 * inner * self.ssm.d_state
        n_l = self.n_layers + self.n_enc_layers
        return emb + n_l * per_layer

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        per_layer_moe_all = d * self.moe.n_experts * self.moe.d_ff_expert * 3
        per_layer_moe_act = d * self.moe.top_k * self.moe.d_ff_expert * 3
        return self.param_count() - self.n_layers * (per_layer_moe_all - per_layer_moe_act)

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests."""
        base = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0, vocab=128, head_dim=16,
            vocab_pad_multiple=32, dtype="float32",
        )
        if self.moe:
            base["moe"] = MoECfg(n_experts=4, top_k=2, d_ff_expert=32)
        if self.ssm:
            base["ssm"] = SSMCfg(d_state=8, head_dim=16, expand=2, conv_width=4)
        if self.xlstm:
            base["xlstm"] = XLSTMCfg(slstm_at=(1,), n_heads=2)
        if self.hybrid:
            base["hybrid"] = HybridCfg(shared_attn_every=2)
        if self.enc_dec:
            base["n_enc_layers"] = 2
        if self.frontend != "none":
            base["frontend_len"] = 8
        base.update(kw)
        return dataclasses.replace(self, **base)


_NESTED = {"moe": MoECfg, "ssm": SSMCfg, "xlstm": XLSTMCfg, "hybrid": HybridCfg}
_LAYERED_ONLY = ("layer_types", "embedding_multiplier", "residual_multiplier",
                 "logits_scaling", "attention_multiplier", "norm_eps")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig):
    """The assignment's skip rules: long_500k only for sub-quadratic archs."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic():
            continue
        out.append(s)
    return out
