"""Decode-time attention/MLP blocks as Stripe programs.

The serving engine's decode step is not one opaque function over the
model: its dense blocks are expressed in the Tile frontend and compiled
through ``stripe_jit`` — frontend → fusion groups → memory planning →
backend — so decode traffic exercises the whole compiler, and every
compile leaves a :class:`~repro_torch.core.driver.CompileRecord` (fusion
groups, kernel counts, per-block backend choices and fallback reasons)
that the engine surfaces via ``compile_records()``.

Four programs cover one transformer layer at decode time (``m`` = rows
flowing through the block: the slot count for decode, the padded bucket
length for prefill):

* ``qkv``    — the three attention input projections sharing one operand;
* ``scores`` — the GQA score contraction ``S[b,k,g,t] += Q·K`` over the
  gathered paged KV (decode only; softmax stays outside — it is not a
  contraction);
* ``values`` — the GQA value contraction ``O[b,k,g,d] += P·V``;
* ``attn_out`` — output projection fused with the residual add;
* ``mlp``    — the FFN with its activation chain fused between the
  matmuls when the activation is exactly representable as Stripe
  intrinsics (``silu``/``relu``/``relu2`` and their GLU forms); for
  activations whose framework semantics differ from the intrinsic
  (tanh-approximated ``gelu``), the matmuls compile through Stripe and
  the activation runs outside, recorded in ``act_outside``.

Programs compute in float32 (matching the reference attention path,
which upcasts for scores/values); callers cast in and out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..core import cache as _cache
from ..core.driver import CompiledProgram, CompileRecord, stripe_jit
from ..core.frontend import TileProgram
from ..core.hwconfig import HardwareConfig
from ..obs import trace as obs_trace

# activations whose Stripe intrinsic chain is semantically identical to
# the framework's nn.core._ACT implementation (see module docstring)
_FUSABLE_ACT = {
    "silu": "silu({x})",
    "relu": "relu({x})",
    "relu2": "square(relu({x}))",
}


def _jit_opts(cfg: "EngineLikeConfig") -> Dict:
    return dict(backend=cfg.backend, use_disk=cfg.use_disk, cache=cfg.cache,
                profile=cfg.profile, tune=cfg.tune, device=cfg.device)


@dataclasses.dataclass
class EngineLikeConfig:
    """The compile-relevant knobs, decoupled from EngineConfig."""

    hw: HardwareConfig
    backend: str = "cuda"
    use_disk: bool = True
    cache: Optional[_cache.CompilationCache] = None
    profile: bool = False
    tune: Any = None  # a repro_torch.tune.TuningDB, or None
    device: str = "cuda"  # where the programs' tensors live (the DB slot)


@dataclasses.dataclass
class DecodePrograms:
    """Stripe-compiled callables for one row-count ``m`` plus records."""

    m: int
    qkv: Callable
    attn_out: Callable
    mlp: Callable
    act_outside: Optional[str]  # activation applied outside the program, if any
    records: Dict[str, CompileRecord]
    scores: Optional[Callable] = None  # decode only (needs the KV window T)
    values: Optional[Callable] = None


def build_qkv_program(cfg, m: int, jc: EngineLikeConfig) -> CompiledProgram:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp = TileProgram(f"serve_qkv_m{m}")
    tp.input("X", (m, d))
    tp.input("WQ", (d, h * hd))
    tp.input("WK", (d, kv * hd))
    tp.input("WV", (d, kv * hd))
    tp.output("Q", (m, h * hd))
    tp.output("K", (m, kv * hd))
    tp.output("V", (m, kv * hd))
    tp.op("Q[b, e] += X[b, d] * WQ[d, e]", name="proj_q")
    tp.op("K[b, e] += X[b, d] * WK[d, e]", name="proj_k")
    tp.op("V[b, e] += X[b, d] * WV[d, e]", name="proj_v")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc))


def build_attn_out_program(cfg, m: int, jc: EngineLikeConfig) -> CompiledProgram:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    tp = TileProgram(f"serve_attn_out_m{m}")
    tp.input("A", (m, h * hd))
    tp.input("R", (m, d))
    tp.input("WO", (h * hd, d))
    tp.temp("T", (m, d))
    tp.output("Y", (m, d))
    tp.op("T[b, d2] += A[b, e] * WO[e, d2]", name="proj_o")
    tp.op("Y[b, d2] = T[b, d2] + R[b, d2]", name="resid")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc))


def build_mlp_program(cfg, m: int, jc: EngineLikeConfig):
    """Returns (compiled, act_outside).  The activation chain is fused
    into the program when exactly representable; otherwise the program
    carries the matmuls and the caller applies the activation between
    ``H`` (and ``G`` for GLU) and the down-projection."""
    d, f = cfg.d_model, cfg.d_ff
    act = cfg.act
    glu = act.endswith("_glu")
    base = act.split("_")[0] if glu else act
    fused = base in _FUSABLE_ACT
    tp = TileProgram(f"serve_mlp_m{m}")
    tp.input("X", (m, d))
    tp.input("R", (m, d))
    tp.input("Wd", (f, d))
    if glu:
        tp.input("Wg", (d, f))
        tp.input("Wu", (d, f))
        if fused:
            tp.temp("G", (m, f))
            tp.temp("U", (m, f))
            tp.temp("A", (m, f))
            tp.op("G[b, f] += X[b, d] * Wg[d, f]", name="mm_gate")
            tp.op("U[b, f] += X[b, d] * Wu[d, f]", name="mm_up")
            gexpr = _FUSABLE_ACT[base].format(x="G[b, f]")
            tp.op(f"A[b, f] = {gexpr} * U[b, f]", name="glu")
            inner = "A"
        else:
            # matmuls through Stripe, activation outside: split programs
            return _split_glu_programs(cfg, m, jc), base
    else:
        tp.input("Wu", (d, f))
        if fused:
            tp.temp("H", (m, f))
            tp.temp("A", (m, f))
            tp.op("H[b, f] += X[b, d] * Wu[d, f]", name="mm_up")
            tp.op(f"A[b, f] = {_FUSABLE_ACT[base].format(x='H[b, f]')}", name="act")
            inner = "A"
        else:
            return _split_plain_programs(cfg, m, jc), base
    tp.temp("O", (m, d))
    tp.output("Y", (m, d))
    tp.op(f"O[b, d2] += {inner}[b, f] * Wd[f, d2]", name="mm_down")
    tp.op("Y[b, d2] = O[b, d2] + R[b, d2]", name="resid")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc)), None


def _split_glu_programs(cfg, m: int, jc: EngineLikeConfig):
    """GLU MLP with the activation outside: an up program producing G and
    U, and a down program applying Wd + residual."""
    d, f = cfg.d_model, cfg.d_ff
    up = TileProgram(f"serve_mlp_up_m{m}")
    up.input("X", (m, d)); up.input("Wg", (d, f)); up.input("Wu", (d, f))
    up.output("G", (m, f)); up.output("U", (m, f))
    up.op("G[b, f] += X[b, d] * Wg[d, f]", name="mm_gate")
    up.op("U[b, f] += X[b, d] * Wu[d, f]", name="mm_up")
    down = _down_program(cfg, m, jc)
    cup = stripe_jit(up.build(), jc.hw, **_jit_opts(jc))
    return _SplitMLP(cup, down, glu=True)


def _split_plain_programs(cfg, m: int, jc: EngineLikeConfig):
    d, f = cfg.d_model, cfg.d_ff
    up = TileProgram(f"serve_mlp_up_m{m}")
    up.input("X", (m, d)); up.input("Wu", (d, f))
    up.output("H", (m, f))
    up.op("H[b, f] += X[b, d] * Wu[d, f]", name="mm_up")
    cup = stripe_jit(up.build(), jc.hw, **_jit_opts(jc))
    return _SplitMLP(cup, _down_program(cfg, m, jc), glu=False)


def _down_program(cfg, m: int, jc: EngineLikeConfig) -> CompiledProgram:
    d, f = cfg.d_model, cfg.d_ff
    tp = TileProgram(f"serve_mlp_down_m{m}")
    tp.input("A", (m, f)); tp.input("R", (m, d)); tp.input("Wd", (f, d))
    tp.temp("O", (m, d))
    tp.output("Y", (m, d))
    tp.op("O[b, d2] += A[b, f] * Wd[f, d2]", name="mm_down")
    tp.op("Y[b, d2] = O[b, d2] + R[b, d2]", name="resid")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc))


@dataclasses.dataclass
class _SplitMLP:
    """Two stripe programs with the activation applied by the caller."""

    up: CompiledProgram
    down: CompiledProgram
    glu: bool

    @property
    def records(self):
        return {"mlp_up": self.up.record, "mlp_down": self.down.record}


def build_scores_program(cfg, m: int, t: int, jc: EngineLikeConfig) -> CompiledProgram:
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    tp = TileProgram(f"serve_scores_m{m}_t{t}")
    tp.input("Q", (m, kv, g, hd))
    tp.input("K", (m, t, kv, hd))
    tp.output("S", (m, kv, g, t))
    tp.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc))


def build_values_program(cfg, m: int, t: int, jc: EngineLikeConfig) -> CompiledProgram:
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    tp = TileProgram(f"serve_values_m{m}_t{t}")
    tp.input("P", (m, kv, g, t))
    tp.input("V", (m, t, kv, hd))
    tp.output("O", (m, kv, g, hd))
    tp.op("O[b, k, g, d] += P[b, k, g, t] * V[b, t, k, d]", name="values")
    return stripe_jit(tp.build(), jc.hw, **_jit_opts(jc))


def build_programs(cfg, m: int, jc: EngineLikeConfig,
                   kv_window: Optional[int] = None) -> DecodePrograms:
    """Compile the serving block programs for row count ``m``.

    ``kv_window`` (the logical paged-KV length T) adds the decode-only
    score/value contractions; prefill callers leave it None (their
    attention is the causal full-sequence einsum).
    """
    qkv = build_qkv_program(cfg, m, jc)
    attn_out = build_attn_out_program(cfg, m, jc)
    mlp, act_outside = build_mlp_program(cfg, m, jc)
    records: Dict[str, CompileRecord] = {
        "qkv": qkv.record, "attn_out": attn_out.record,
    }
    if isinstance(mlp, _SplitMLP):
        records.update(mlp.records)
    else:
        records["mlp"] = mlp.record
    scores = values = None
    if kv_window is not None:
        scores = build_scores_program(cfg, m, kv_window, jc)
        values = build_values_program(cfg, m, kv_window, jc)
        records["attn_scores"] = scores.record
        records["attn_values"] = values.record
    return DecodePrograms(m=m, qkv=qkv, attn_out=attn_out, mlp=mlp,
                          act_outside=act_outside, records=records,
                          scores=scores, values=values)


# ------------------------------------------------------------------ apply
# The weights are cast to float32 on every call, as the JAX package does
# (its programs compute in float32): with bf16 weights this is a
# read-and-write pass over every weight per call.  Each group of casts is
# one ``block.cast`` span, timed on the device.
def run_qkv(progs: DecodePrograms, x2d: torch.Tensor, wq, wk, wv):
    with obs_trace.span("block.cast", device=True):
        wq, wk, wv = wq.float(), wk.float(), wv.float()
    out = progs.qkv({"X": x2d.float(), "WQ": wq, "WK": wk, "WV": wv})
    return out["Q"], out["K"], out["V"]


def run_attn_out(progs: DecodePrograms, attn2d: torch.Tensor, resid2d: torch.Tensor, wo):
    with obs_trace.span("block.cast", device=True):
        wo = wo.float()
    out = progs.attn_out({"A": attn2d.float(), "R": resid2d.float(), "WO": wo})
    return out["Y"]


def run_mlp(progs: DecodePrograms, x2d: torch.Tensor, resid2d: torch.Tensor, mlp_params, act: str):
    """Apply the (possibly split) MLP program, matching the framework's
    MLP (activation table ``nn.core._ACT``)."""
    from ..nn.core import _ACT

    x2d = x2d.float()
    resid2d = resid2d.float()
    mlp = progs.mlp
    glu = act.endswith("_glu")
    if isinstance(mlp, _SplitMLP):
        with obs_trace.span("block.cast", device=True):
            up = {"Wg": mlp_params["w_gate"].float()} if glu else {}
            up["Wu"] = mlp_params["w_up"].float()
        got = mlp.up({"X": x2d, **up})
        if glu:
            a = _ACT[progs.act_outside](got["G"]) * got["U"]
        else:
            a = _ACT[progs.act_outside](got["H"])
        with obs_trace.span("block.cast", device=True):
            wd = mlp_params["w_down"].float()
        return mlp.down({"A": a, "R": resid2d, "Wd": wd})["Y"]
    with obs_trace.span("block.cast", device=True):
        w = {"Wd": mlp_params["w_down"].float()}
        if glu:
            w["Wg"] = mlp_params["w_gate"].float()
        w["Wu"] = mlp_params["w_up"].float()
    return mlp({"X": x2d, "R": resid2d, **w})["Y"]
