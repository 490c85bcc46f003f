"""Workload corpus for design-space sweeps.

Every sweep point is scored on a *corpus* of programs, not one kernel —
a hardware config that wins on a single matmul but loses on attention or
MoE FFN shapes is exactly the false positive design exploration exists
to catch.  The corpus mirrors the shapes the framework actually runs:

* ``mm_bias_gelu``   — the oplib linear layer (matmul → bias → gelu);
* ``ffn_relu2``      — nemotron-style squared-ReLU FFN chain
                       (mm → bias → relu → square → mm), the fusion
                       bench's headline workload;
* ``attn_scores``    — the flash-attention score contraction
                       S[q,k] += Q[q,d]·K[k,d] at a serving shape;
* ``moe_ffn``        — one expert's gated FFN (llama/mixtral style):
                       silu(X·W1) ⊙ (X·W3) · W2, a multi-consumer
                       diamond for the fusion pass;
* ``fig4_conv``      — the paper's Fig. 4/5 int8 3×3 conv (the
                       cache-line cost model's reference program);
* ``fig5_conv_f32``  — the same conv in f32 (the executable Fig. 5
                       variant the benchmarks measure);
* ``conv_mlp``       — conv head + channel-mixing matmul, the mixed
                       program the per-block hybrid Pallas backend runs
                       (windowed conv kernel + dense matmul kernel).

Shapes are deliberately modest (compile-speed-bound: a 32-point sweep
compiles every workload at every unique config) but large enough on the
tiled dims that tiling decisions change predicted traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

from ..core.frontend import TileProgram, single_op_program
from ..core.ir import Program


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    build: Callable[[], Program]
    tags: tuple = ()


def mm_bias_gelu(m: int = 512, k: int = 512, n: int = 1024) -> Program:
    tp = TileProgram("mm_bias_gelu")
    tp.input("X", (m, k), "bfloat16")
    tp.input("W", (k, n), "bfloat16")
    tp.input("B", (n,), "float32")
    tp.temp("T", (m, n))
    tp.output("O", (m, n), "bfloat16")
    tp.op("T[i, j] += X[i, c] * W[c, j]", name="mm")
    tp.op("O[i, j] = gelu(T[i, j] + B[j])", name="bias_gelu")
    return tp.build()


def ffn_relu2(m: int = 512, k: int = 64, n: int = 1024, n2: int = 64) -> Program:
    tp = TileProgram("ffn_relu2")
    tp.input("A", (m, k), "bfloat16")
    tp.input("B", (k, n), "bfloat16")
    tp.input("b", (n,), "float32")
    tp.input("W2", (n, n2), "bfloat16")
    tp.temp("T", (m, n))
    tp.temp("U", (m, n))
    tp.temp("V", (m, n))
    tp.output("O", (m, n2), "bfloat16")
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm1")
    tp.op("U[i, j] = T[i, j] + b[j]", name="bias")
    tp.op("V[i, j] = square(relu(U[i, j]))", name="relu2")
    tp.op("O[i, j2] += V[i, j] * W2[j, j2]", name="mm2")
    return tp.build()


def attn_scores(seq: int = 1024, head_dim: int = 128) -> Program:
    return single_op_program(
        "S[q, k] += Q[q, d] * K[k, d]",
        {"Q": ((seq, head_dim), "bfloat16"), "K": ((seq, head_dim), "bfloat16"),
         "S": ((seq, seq), "float32")},
        out="S", name="attn_scores")


def moe_ffn(tokens: int = 256, d: int = 512, hidden: int = 1024) -> Program:
    tp = TileProgram("moe_ffn")
    tp.input("X", (tokens, d), "bfloat16")
    tp.input("W1", (d, hidden), "bfloat16")
    tp.input("W3", (d, hidden), "bfloat16")
    tp.input("W2", (hidden, d), "bfloat16")
    tp.temp("H", (tokens, hidden))
    tp.temp("U", (tokens, hidden))
    tp.temp("G", (tokens, hidden))
    tp.output("O", (tokens, d), "bfloat16")
    tp.op("H[t, h] += X[t, c] * W1[c, h]", name="up")
    tp.op("U[t, h] += X[t, c] * W3[c, h]", name="gate_mm")
    tp.op("G[t, h] = silu(H[t, h]) * U[t, h]", name="gate")
    tp.op("O[t, e] += G[t, h] * W2[h, e]", name="down")
    return tp.build()


def fig4_conv() -> Program:
    return single_op_program(
        "O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]",
        {"I": ((12, 16, 8), "int8"), "F": ((3, 3, 8, 16), "int8"),
         "O": ((12, 16, 16), "int32")},
        out="O", name="fig4_conv")


def fig5_conv_f32() -> Program:
    return single_op_program(
        "O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]",
        {"I": ((12, 16, 8), "float32"), "F": ((3, 3, 8, 16), "float32"),
         "O": ((12, 16, 16), "float32")},
        out="O", name="fig5_conv_f32")


def conv_mlp(x: int = 24, y: int = 24, c: int = 8, k: int = 16, m: int = 32) -> Program:
    """Conv head + channel-mixing matmul: a mixed program for the
    per-block hybrid backend — the conv lowers via the halo-aware
    windowed path, the matmul via the dense contraction path, and the
    kernel-count axis reflects both."""
    tp = TileProgram("conv_mlp")
    tp.input("I", (x, y, c))
    tp.input("F", (3, 3, c, k))
    tp.input("W", (k, m))
    tp.temp("C", (x, y, k))
    tp.output("O", (x, y, m))
    tp.op("C[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]", name="conv")
    tp.op("O[x, y, m] += C[x, y, k] * W[k, m]", name="proj")
    return tp.build()


def resnet50_conv2_3x3(batch: int = 8, dtype: str = "float32") -> Program:
    """The 3x3 convolution of ResNet-50's conv2_x stage (He et al. 2016,
    Table 1): 56x56 maps, 64 -> 64 channels, stride 1, zero padding 1, in
    NHWC.  An int8 layer accumulates into int32.  Not in the sweep corpus
    (its compile alone takes seconds): the card check measures the
    windowed kernel on it at real size."""
    out_dtype = "int32" if dtype == "int8" else dtype
    return single_op_program(
        "O[b, x, y, k] += I[b, x + i - 1, y + j - 1, c] * F[i, j, c, k]",
        {"I": ((batch, 56, 56, 64), dtype), "F": ((3, 3, 64, 64), dtype),
         "O": ((batch, 56, 56, 64), out_dtype)},
        out="O", name=f"resnet50_conv2_3x3_{dtype}")


_ALL: Dict[str, Workload] = {w.name: w for w in (
    Workload("mm_bias_gelu", mm_bias_gelu, tags=("linear", "fusion")),
    Workload("ffn_relu2", ffn_relu2, tags=("ffn", "fusion")),
    Workload("attn_scores", attn_scores, tags=("attention",)),
    Workload("moe_ffn", moe_ffn, tags=("moe", "diamond")),
    Workload("fig4_conv", fig4_conv, tags=("paper", "conv")),
    Workload("fig5_conv_f32", fig5_conv_f32, tags=("paper", "conv")),
    Workload("conv_mlp", conv_mlp, tags=("conv", "hybrid")),
)}

CORPORA: Dict[str, Sequence[str]] = {
    "default": ("mm_bias_gelu", "ffn_relu2", "attn_scores", "moe_ffn", "fig4_conv"),
    "paper": ("fig4_conv", "fig5_conv_f32"),
    "quick": ("mm_bias_gelu", "fig4_conv"),
    "all": tuple(_ALL),
}


def get_workloads(spec: str = "default") -> List[Workload]:
    """Resolve a corpus name or a comma-separated workload list."""
    names = CORPORA.get(spec)
    if names is None:
        names = tuple(s.strip() for s in spec.split(",") if s.strip())
    out = []
    for n in names:
        if n not in _ALL:
            raise KeyError(f"unknown workload {n!r}; available workloads "
                           f"{sorted(_ALL)} or corpora {sorted(CORPORA)}")
        out.append(_ALL[n])
    if not out:
        raise KeyError(f"empty workload spec {spec!r}")
    return out
