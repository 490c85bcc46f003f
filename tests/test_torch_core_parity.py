"""The port's framework-neutral core against the JAX package's: the same
programs compile to the same optimized IR (``ir_fingerprint``), the same
pass trace (fusion decisions included), the same tilings and fusion
groups, and the reference interpreter gives the same outputs — exactly —
under the three configs both packages share."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.core.driver import compile_cached as j_compile  # noqa: E402
from repro.core.frontend import TileProgram as JTile  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.core.interp import execute_reference as j_interp  # noqa: E402
from repro.core.ir import ir_fingerprint as j_fp  # noqa: E402
from repro.explore.workloads import get_workloads as j_workloads  # noqa: E402
from repro.serving import stripe_decode as j_sd  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core.driver import compile_cached as t_compile  # noqa: E402
from repro_torch.core.frontend import TileProgram as TTile  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.core.interp import execute_reference as t_interp  # noqa: E402
from repro_torch.core.ir import ir_fingerprint as t_fp  # noqa: E402
from repro_torch.explore.workloads import get_workloads as t_workloads  # noqa: E402
from repro_torch.serving import stripe_decode as t_sd  # noqa: E402
from test_torch_moe import _as_reference  # noqa: E402

CONFIGS = ("cpu_test", "tpu_v5e", "paper_fig4")
SCALED = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
              head_dim=16, vocab_pad_multiple=16)


# ----------------------------------------------------------- programs
# The programs of tests/test_fusion_groups.py, built by either package's
# frontend from the same text.
def _chain(tp_cls, with_second_mm=True):
    tp = tp_cls("chain")
    tp.input("A", (16, 12)); tp.input("B", (12, 24)); tp.input("b", (24,))
    tp.temp("T", (16, 24)); tp.temp("U", (16, 24))
    if with_second_mm:
        tp.input("W2", (24, 8)); tp.temp("G", (16, 24)); tp.output("O", (16, 8))
    else:
        tp.output("G", (16, 24))
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm1")
    tp.op("U[i, j] = T[i, j] + b[j]", name="bias")
    tp.op("G[i, j] = gelu(U[i, j])", name="act")
    if with_second_mm:
        tp.op("O[i, k2] += G[i, j] * W2[j, k2]", name="mm2")
    return tp


def _diamond(tp_cls):
    tp = tp_cls("diamond")
    tp.input("A", (16, 12)); tp.input("B", (12, 24))
    tp.temp("T", (16, 24)); tp.temp("U", (16, 24)); tp.temp("V", (16, 24))
    tp.output("O", (16, 24))
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm")
    tp.op("U[i, j] = relu(T[i, j])", name="r")
    tp.op("V[i, j] = sigmoid(T[i, j])", name="s")
    tp.op("O[i, j] = U[i, j] * V[i, j]", name="join")
    return tp


def _prologue(tp_cls):
    tp = tp_cls("pro")
    tp.input("X", (16, 12)); tp.input("W", (12, 24))
    tp.temp("X2", (16, 12)); tp.output("O", (16, 24))
    tp.op("X2[i, c] = gelu(X[i, c])", name="pre")
    tp.op("O[i, j] += X2[i, c] * W[c, j]", name="mm")
    return tp


def _permuted(tp_cls):
    tp = tp_cls("perm")
    tp.input("A", (16, 16)); tp.input("B", (16, 16))
    tp.temp("T", (16, 16)); tp.output("U", (16, 16))
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm")
    tp.op("U[i, j] = relu(T[j, i])", name="tr")
    return tp


def _pressure(tp_cls):
    tp = tp_cls("pressure")
    tp.input("A", (32, 16)); tp.input("B", (16, 32))
    tp.input("E", (32, 32)); tp.input("F", (32, 32))
    tp.temp("T", (32, 32)); tp.temp("U", (32, 32)); tp.output("O", (32, 32))
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm")
    tp.op("U[i, j] = relu(T[i, j])", name="r")
    tp.op("O[i, j] = U[i, j] + E[i, j] * F[i, j]", name="wide")
    return tp


FUSION_PROGRAMS = {"chain": _chain, "chain1": lambda c: _chain(c, False),
                   "diamond": _diamond, "prologue": _prologue,
                   "permuted": _permuted, "pressure": _pressure}
WORKLOADS = [w.name for w in j_workloads("all")]


def _trace_json(trace):
    return json.dumps(trace, sort_keys=True, default=repr)


def _inputs(prog, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name in prog.inputs:
        d = prog.buffers[name]
        if str(d.dtype).startswith("int"):
            out[name] = rng.randint(-8, 8, size=d.shape).astype(d.dtype)
        else:
            out[name] = rng.randn(*d.shape).astype(d.dtype)
    return out


def _assert_same_compile(jprog, tprog, hw):
    assert j_fp(jprog) == t_fp(tprog), "frontends built different IR"
    jopt, jrec = j_compile(jprog, j_hw(hw), cache=j_cache.CompilationCache(use_disk=False),
                           use_disk=False)
    topt, trec = t_compile(tprog, t_hw(hw), cache=t_cache.CompilationCache(use_disk=False),
                           use_disk=False)
    assert j_fp(jopt) == t_fp(topt)
    assert _trace_json(jrec.pass_trace) == _trace_json(trec.pass_trace)
    assert jrec.fusion_decisions() == trec.fusion_decisions() or \
        repr(jrec.fusion_decisions()) == repr(trec.fusion_decisions())
    assert jrec.tilings == trec.tilings
    assert jrec.groups == trec.groups
    assert jrec.n_kernels == trec.n_kernels


def _assert_same_interp(jprog, tprog):
    arrays = _inputs(jprog)
    want = j_interp(jprog, arrays)
    got = t_interp(tprog, arrays)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("hw", CONFIGS)
@pytest.mark.parametrize("name", sorted(FUSION_PROGRAMS))
def test_fusion_programs_compile_identically(name, hw):
    build = FUSION_PROGRAMS[name]
    _assert_same_compile(build(JTile).build(), build(TTile).build(), hw)


@pytest.mark.parametrize("name", sorted(FUSION_PROGRAMS))
def test_fusion_programs_interpret_identically(name):
    build = FUSION_PROGRAMS[name]
    _assert_same_interp(build(JTile).build(), build(TTile).build())


# paper_fig4's divisor search on conv_mlp alone would take a third of this
# file's time: cpu_test and tpu_v5e cover that workload
WORKLOAD_CASES = [(n, hw) for n in WORKLOADS for hw in CONFIGS
                  if (n, hw) != ("conv_mlp", "paper_fig4")]


@pytest.mark.parametrize("name,hw", WORKLOAD_CASES)
def test_workloads_compile_identically(name, hw):
    jw = {w.name: w for w in j_workloads("all")}[name]
    tw = {w.name: w for w in t_workloads("all")}[name]
    assert jw.tags == tw.tags
    _assert_same_compile(jw.build(), tw.build(), hw)


def test_workload_corpora_match():
    from repro.explore.workloads import CORPORA as jc
    from repro_torch.explore.workloads import CORPORA as tc
    assert {k: tuple(v) for k, v in jc.items()} == {k: tuple(v) for k, v in tc.items()}


@pytest.mark.parametrize("name", ["fig4_conv"])
def test_workloads_interpret_identically(name):
    jw = {w.name: w for w in j_workloads("all")}[name]
    tw = {w.name: w for w in t_workloads("all")}[name]
    _assert_same_interp(jw.build(), tw.build())


def _serving_records(mod, cfg, hw_get, hw, m, window):
    jc = mod.EngineLikeConfig(hw=hw_get(hw), backend="reference", use_disk=False,
                              cache=(j_cache if mod is j_sd else t_cache)
                              .CompilationCache(use_disk=False))
    progs = mod.build_programs(cfg, m, jc, kv_window=window)
    out = {}
    for name in ("qkv", "attn_out", "mlp", "scores", "values"):
        c = getattr(progs, name)
        if c is not None:
            out[name] = c
    return out


def _assert_same_serving(jcfg, tcfg, hw, m, window, interp=False):
    jp = _serving_records(j_sd, jcfg, j_hw, hw, m, window)
    tp = _serving_records(t_sd, tcfg, t_hw, hw, m, window)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        jc, tc = jp[name], tp[name]
        assert j_fp(jc.program) == t_fp(tc.program), name
        assert _trace_json(jc.record.pass_trace) == _trace_json(tc.record.pass_trace), name
        assert jc.record.tilings == tc.record.tilings, name
        assert jc.record.groups == tc.record.groups, name
        if interp:
            _assert_same_interp(jc.program.source, tc.program.source)


@pytest.mark.parametrize("hw", CONFIGS)
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_serving_programs_compile_identically_scaled(phase, hw):
    jcfg = j_configs.get("llama3-8b").scaled(**SCALED)
    tcfg = t_configs.get("llama3-8b").scaled(**SCALED)
    m, window = (2, 48) if phase == "decode" else (8, None)
    _assert_same_serving(jcfg, tcfg, hw, m, window, interp=hw == "cpu_test")


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_serving_programs_compile_identically_full_width(phase):
    jcfg, tcfg = j_configs.get("llama3-8b"), t_configs.get("llama3-8b")
    # the reference's config, field by field; the port's own fields (the
    # layered family's, ``test_torch_moe``) at their defaults
    assert _as_reference(tcfg, jcfg) == dataclasses.asdict(jcfg)
    m, window = (8, 256) if phase == "decode" else (64, None)
    _assert_same_serving(jcfg, tcfg, "tpu_v5e", m, window)


def test_shared_configs_keep_their_fingerprints():
    for name in CONFIGS:
        assert j_hw(name).fingerprint() == t_hw(name).fingerprint()


def test_h100_config_is_spec_sheet_and_fits_smem():
    hw = t_hw("h100")
    assert hw.mem("HBM").bandwidth == 3.35e12
    assert hw.mem("SMEM").size_bytes == 232_448
    params = dict(hw.passes)
    assert params["localize"]["inner"] == "SMEM" and params["schedule"]["unit"] == "SMEM"
    # a plan tile is capped at a fraction of the inner unit that fits SMEM
    assert hw.inner_mem().size_bytes * params["autotile"]["mem_cap_frac"] <= 232_448
    assert hw.fingerprint() not in {j_hw(n).fingerprint() for n in CONFIGS}


def test_cache_keys_carry_a_port_tag():
    assert t_cache.PORT_TAG == "repro_torch"
    prog = _chain(TTile).build()
    _, rec = t_compile(prog, t_hw("cpu_test"), cache=t_cache.CompilationCache(use_disk=False),
                       use_disk=False)
    _, jrec = j_compile(_chain(JTile).build(), j_hw("cpu_test"),
                        cache=j_cache.CompilationCache(use_disk=False), use_disk=False)
    assert rec.key != jrec.key
