"""The port's lowerings against the JAX package's.

* ``lower_torch`` against ``lower_jnp`` on the same semantic programs
  (float32 within rtol 1e-5 / atol 1e-6; the int8 -> int32 conv exactly);
* the CUDA backend's plan extraction against the Pallas backend's, field
  by field;
* the ``"cuda"`` backend on CPU tensors (the composer plus the kernel's
  plain version) against the reference's ``pallas`` backend in interpret
  mode where that backend is right, and against its ``jnp`` backend on the
  GQA ``scores``/``values`` programs, where ``_emit_contraction`` has no
  batch dims;
* the compile records (groups, kernel counts, per-unit backends);
* the postfix op-code compiler, run by a plain Python evaluator, against
  the tile-compute DAGs it came from.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.core import lower_pallas as LP  # noqa: E402
from repro.core.driver import compile_cached as j_compile  # noqa: E402
from repro.core.driver import stripe_jit as j_jit  # noqa: E402
from repro.core.frontend import TileProgram as JTile  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.core.ir import Block  # noqa: E402
from repro.core.lower_jnp import lower_program_jnp  # noqa: E402
from repro.explore.workloads import get_workloads as j_workloads  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import lower_cuda as LC  # noqa: E402
from repro_torch.core.driver import compile_cached as t_compile  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram as TTile  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.core.ir import Block as TBlock  # noqa: E402
from repro_torch.core.lower_torch import lower_program_torch  # noqa: E402
from repro_torch.explore.workloads import get_workloads as t_workloads  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402

from test_torch_core_parity import FUSION_PROGRAMS, SCALED, _inputs  # noqa: E402

SERVING = ("qkv", "attn_out", "mlp", "scores", "values")


def _serving_program(tp_cls, name, cfg, m=2, t=16):
    """The serving engine's Tile programs (serving/stripe_decode.py)."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    g = h // kv
    tp = tp_cls(f"serve_{name}")
    if name == "qkv":
        tp.input("X", (m, d)); tp.input("WQ", (d, h * hd))
        tp.input("WK", (d, kv * hd)); tp.input("WV", (d, kv * hd))
        tp.output("Q", (m, h * hd)); tp.output("K", (m, kv * hd)); tp.output("V", (m, kv * hd))
        tp.op("Q[b, e] += X[b, d] * WQ[d, e]", name="proj_q")
        tp.op("K[b, e] += X[b, d] * WK[d, e]", name="proj_k")
        tp.op("V[b, e] += X[b, d] * WV[d, e]", name="proj_v")
    elif name == "attn_out":
        tp.input("A", (m, h * hd)); tp.input("R", (m, d)); tp.input("WO", (h * hd, d))
        tp.temp("T", (m, d)); tp.output("Y", (m, d))
        tp.op("T[b, d2] += A[b, e] * WO[e, d2]", name="proj_o")
        tp.op("Y[b, d2] = T[b, d2] + R[b, d2]", name="resid")
    elif name == "mlp":
        tp.input("X", (m, d)); tp.input("R", (m, d)); tp.input("Wd", (f, d))
        tp.input("Wg", (d, f)); tp.input("Wu", (d, f))
        tp.temp("G", (m, f)); tp.temp("U", (m, f)); tp.temp("A", (m, f))
        tp.temp("O", (m, d)); tp.output("Y", (m, d))
        tp.op("G[b, f] += X[b, d] * Wg[d, f]", name="mm_gate")
        tp.op("U[b, f] += X[b, d] * Wu[d, f]", name="mm_up")
        tp.op("A[b, f] = silu(G[b, f]) * U[b, f]", name="glu")
        tp.op("O[b, d2] += A[b, f] * Wd[f, d2]", name="mm_down")
        tp.op("Y[b, d2] = O[b, d2] + R[b, d2]", name="resid")
    elif name == "scores":
        tp.input("Q", (m, kv, g, hd)); tp.input("K", (m, t, kv, hd))
        tp.output("S", (m, kv, g, t))
        tp.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    else:
        tp.input("P", (m, kv, g, t)); tp.input("V", (m, t, kv, hd))
        tp.output("O", (m, kv, g, hd))
        tp.op("O[b, k, g, d] += P[b, k, g, t] * V[b, t, k, d]", name="values")
    return tp


def _cfg(pkg):
    return pkg.get("llama3-8b").scaled(**SCALED)


def _programs():
    """(name, JAX-package program, port program) for every test program."""
    out = []
    for name, build in sorted(FUSION_PROGRAMS.items()):
        out.append((name, lambda b=build: b(JTile).build(), lambda b=build: b(TTile).build()))
    for name in SERVING:
        out.append((f"serve_{name}",
                    lambda n=name: _serving_program(JTile, n, _cfg(j_configs)).build(),
                    lambda n=name: _serving_program(TTile, n, _cfg(t_configs)).build()))
    return out


PROGRAMS = {n: (j, t) for n, j, t in _programs()}
WORKLOADS = ("mm_bias_gelu", "ffn_relu2", "attn_scores", "moe_ffn", "fig4_conv",
             "fig5_conv_f32")


def _to_np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _torch(v: np.ndarray) -> torch.Tensor:
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(v)


def _assert_outputs(got, want, exact=False, rtol=1e-5, atol=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        bf16 = np.asarray(want[k]).dtype.name == "bfloat16"
        g, w = _to_np(got[k]), _to_np(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if bf16:
            # both round the float32 result to bfloat16 (8 mantissa bits)
            rtol, atol = max(rtol, 1e-2), max(atol, 1e-2)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ----------------------------------------------------- lower_torch vs jnp
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_lower_torch_matches_jnp(name):
    jbuild, tbuild = PROGRAMS[name]
    jprog, tprog = jbuild(), tbuild()
    arrays = _inputs(jprog, seed=1)
    want = lower_program_jnp(jprog)(arrays)
    got = lower_program_torch(tprog)({k: _torch(v) for k, v in arrays.items()})
    _assert_outputs(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", WORKLOADS)
def test_lower_torch_matches_jnp_on_workloads(name):
    jprog = {w.name: w for w in j_workloads("all")}[name].build()
    tprog = {w.name: w for w in t_workloads("all")}[name].build()
    # grouped lowering: the fusion groups of the compiled program
    groups = j_compile(jprog, j_hw("tpu_v5e"), cache=j_cache.CompilationCache(use_disk=False),
                       use_disk=False)[1].groups
    arrays = _inputs(jprog, seed=2)
    want = lower_program_jnp(jprog, groups=groups)(arrays)
    got = lower_program_torch(tprog, groups=groups)(
        {k: _torch(v) for k, v in arrays.items()})
    is_int = any(str(d.dtype).startswith("int") for d in jprog.buffers.values())
    # sums of 512-1024 float32 terms in two summation orders: the error is
    # relative to the sum's scale (outputs reach ~250 here), not the element
    scale = max(float(np.abs(_to_np(v)).max()) for v in want.values())
    _assert_outputs(got, want, exact=is_int, rtol=1e-5, atol=2e-6 * max(1.0, scale))


# -------------------------------------------------- plan extraction parity
def _opt_blocks(hw, jprog, tprog):
    jopt, _ = j_compile(jprog, j_hw(hw), cache=j_cache.CompilationCache(use_disk=False),
                        use_disk=False)
    topt, _ = t_compile(tprog, t_hw(hw), cache=t_cache.CompilationCache(use_disk=False),
                        use_disk=False)
    jb = [s for s in jopt.entry.stmts if isinstance(s, Block)]
    tb = [s for s in topt.entry.stmts if isinstance(s, TBlock)]
    assert [b.name for b in jb] == [b.name for b in tb]
    return list(zip(jb, tb))


def _dims(gr):
    return (gr.ref.into, gr.ref.from_buf, gr.dim_vars, gr.block_shape,
            tuple((d.var, d.step, d.base, d.size) for d in gr.dims))


@pytest.mark.parametrize("hw", ["tpu_v5e", "cpu_test"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_extract_contraction_matches_pallas(name, hw):
    jbuild, tbuild = PROGRAMS[name]
    for jb, tb in _opt_blocks(hw, jbuild(), tbuild()):
        try:
            want = LP.extract_contraction(LP._ensure_grid(jb))
        except LP.UnsupportedPallas as e:
            with pytest.raises(LC.UnsupportedCuda) as got:
                LC.extract_contraction(LC._ensure_grid(tb))
            assert str(got.value) == str(e)
            continue
        got = LC.extract_contraction(LC._ensure_grid(tb))
        for f in ("grid_order", "grid_sizes", "red_vars", "lhs_bufs", "rhs_bufs", "scale",
                  "lhs_contract", "rhs_contract", "acc_scalar"):
            assert getattr(got, f) == getattr(want, f), f
        assert [_dims(g) for g in got.in_refs] == [_dims(g) for g in want.in_refs]
        assert _dims(got.out_ref) == _dims(want.out_ref)
        assert repr(got.lhs) == repr(want.lhs) and repr(got.rhs) == repr(want.rhs)
        assert repr(got.epilogue) == repr(want.epilogue)


# ------------------------------------------- the cuda backend on the CPU
def _spy_reference_emitters(monkeypatch):
    """Record which Pallas emitter lowered each block (by output buffer)."""
    used = {}
    for emitter in ("_emit_contraction", "_emit_elementwise", "_emit_windowed"):
        orig = getattr(LP, emitter)

        def spy(plan, *a, _orig=orig, _name=emitter, **kw):
            fn = _orig(plan, *a, **kw)
            used.setdefault(plan.out_ref.ref.from_buf, set()).add(_name)
            return fn
        monkeypatch.setattr(LP, emitter, spy)
    return used


def _run_both(jprog, tprog, hw, ref_backend, monkeypatch):
    used = _spy_reference_emitters(monkeypatch)
    jc = j_jit(jprog, j_hw(hw), ref_backend, interpret=True,
               cache=j_cache.CompilationCache(use_disk=False), use_disk=False)
    tc = t_jit(tprog, t_hw(hw), "cuda", cache=t_cache.CompilationCache(use_disk=False),
               use_disk=False)
    arrays = _inputs(jprog, seed=3)
    want = jc({k: jnp.asarray(v) for k, v in arrays.items()})
    got = tc({k: _torch(v) for k, v in arrays.items()})
    return jc.record, tc.record, used, want, got


# programs whose units the reference's Pallas backend computes right: no
# output dim that both operands share
PALLAS_OK = sorted(n for n in PROGRAMS if n not in ("serve_scores", "serve_values"))


@pytest.mark.parametrize("name", PALLAS_OK)
def test_cuda_backend_matches_pallas_interpret(name, monkeypatch):
    jbuild, tbuild = PROGRAMS[name]
    jrec, trec, used, want, got = _run_both(jbuild(), tbuild(), "tpu_v5e", "pallas",
                                            monkeypatch)
    _assert_outputs(got, want, rtol=1e-5, atol=1e-5)
    assert trec.groups == jrec.groups
    # a unit the reference lowered through its contraction emitter runs the
    # CUDA kernel; one it lowered through the (not yet ported) elementwise
    # or windowed emitter falls back to torch, with the reason on record
    expect = {}
    for unit, backend in jrec.block_backends.items():
        if backend == "jnp":
            expect[unit] = "torch"
    assert set(trec.block_backends) == set(jrec.block_backends)
    for unit, backend in trec.block_backends.items():
        if unit in expect:
            assert backend == "torch"
        elif backend == "torch":
            assert "not yet ported" in trec.block_fallbacks[unit]
        else:
            assert backend == "cuda"
    n_torch = sum(1 for b in trec.block_backends.values() if b == "torch")
    if n_torch == 0:
        assert trec.n_kernels == jrec.n_kernels
        assert trec.backend == "cuda" and jrec.backend == "pallas"
    kernels = {b for emitters in used.values() for b in emitters}
    if kernels <= {"_emit_contraction"} and trec.block_backends:
        assert all(b == "cuda" for b in trec.block_backends.values())


@pytest.mark.parametrize("name", ["serve_scores", "serve_values"])
def test_cuda_backend_batches_shared_output_dims(name, monkeypatch):
    """The GQA programs: the kernel treats the output dims both operands
    share (b, k) as batch dims; the reference's jnp backend is the oracle."""
    jbuild, tbuild = PROGRAMS[name]
    jrec, trec, _used, want, got = _run_both(jbuild(), tbuild(), "tpu_v5e", "jnp",
                                             monkeypatch)
    _assert_outputs(got, want, rtol=1e-5, atol=1e-5)
    assert trec.backend == "cuda" and set(trec.block_backends.values()) == {"cuda"}
    assert trec.groups == jrec.groups


@pytest.mark.parametrize("hw", ["h100", "tpu_v5e", "cpu_test"])
def test_cuda_backend_full_serving_path_on_h100_tilings(hw):
    """Every serving program lowers every unit to the kernel, and the plain
    version agrees with the torch backend."""
    cfg = _cfg(t_configs)
    for name in SERVING:
        prog = _serving_program(TTile, name, cfg, m=4, t=32).build()
        c = t_jit(prog, t_hw(hw), "cuda", cache=t_cache.CompilationCache(use_disk=False),
                  use_disk=False)
        r = t_jit(prog, t_hw(hw), "torch", cache=t_cache.CompilationCache(use_disk=False),
                  use_disk=False)
        assert c.record.backend == "cuda" and not c.record.fallback_reasons(), name
        assert set(c.record.block_backends.values()) == {"cuda"}, name
        arrays = {k: torch.from_numpy(v) for k, v in _inputs(prog, seed=4).items()}
        want = r(arrays)
        _assert_outputs(c(arrays), {k: want[k] for k in prog.outputs}, rtol=1e-5, atol=1e-5)


def test_full_width_serving_programs_lower_to_the_kernel():
    """At llama3-8b's full width under h100, every unit of the decode and
    prefill programs is one kernel launch, with no fallback reason."""
    from repro_torch.serving import stripe_decode as sd

    cfg = t_configs.get("llama3-8b")
    jc = sd.EngineLikeConfig(hw=t_hw("h100"), backend="cuda", use_disk=False,
                             cache=t_cache.CompilationCache(use_disk=False))
    units = 0
    for m, window in ((4, 256), (128, None)):
        progs = sd.build_programs(cfg, m, jc, kv_window=window)
        for rec in progs.records.values():
            assert rec.backend == "cuda" and not rec.fallback_reasons()
            assert set(rec.block_backends.values()) == {"cuda"}
            units += len(rec.block_backends)
    assert units == 16


def test_driver_rejects_unported_arguments():
    """``mesh=`` is ported (ROADMAP A9a); a device count takes the
    machine's first cards, so one larger than the machine has is
    refused, naming the explicit devices that emulate them, and never
    runs on the CPU."""
    prog = FUSION_PROGRAMS["chain"](TTile).build()
    with pytest.raises(ValueError, match="explicit devices"):
        t_jit(prog, t_hw("cpu_test"), "cuda", mesh=torch.cuda.device_count() + 2)


@pytest.mark.parametrize("with_db", [True, False])
def test_residual_log_rotation(tmp_path, with_db):
    """The port's residual log rotates as the reference's does: the newest
    half stays and a given DB receives the rest; with no DB given the rest
    folds into the tuning DB beside the log."""
    from repro.obs import profile as j_profile
    from repro_torch.obs import profile as t_profile

    class _DB:
        def __init__(self):
            self.rows = []

        def fold_residuals(self, rows):
            self.rows.extend(rows)

    rows = [{"block": f"b{i}", "predicted_s": 1e-6, "measured_s": 2e-6 * (i + 1)}
            for i in range(9)]
    logs = {}
    for name, mod in (("ref", j_profile), ("port", t_profile)):
        db = _DB() if with_db or name == "ref" else None
        path = tmp_path / name / "residuals.jsonl"
        for r in rows:
            mod.append_residuals([r], path=path, cap=4, db=db)
        logs[name] = (mod.read_residuals(path), db.rows if db is not None else None)
    assert logs["port"][0] == logs["ref"][0]
    assert len(logs["port"][0]) < len(rows)
    if with_db:
        assert logs["port"][1] == logs["ref"][1]
    else:
        from repro_torch.tune import TuningDB

        folded = TuningDB(dir=tmp_path / "port").residual_summaries()
        assert sum(f["rows"] for f in folded) == len(logs["ref"][1])


def test_kernel_wrapper_uses_plain_version_only_for_cpu_tensors():
    prog = _serving_program(TTile, "attn_out", _cfg(t_configs)).build()
    c = t_jit(prog, t_hw("h100"), "cuda", cache=t_cache.CompilationCache(use_disk=False),
              use_disk=False)
    before = K.launches
    c({k: torch.from_numpy(v) for k, v in _inputs(prog).items()})
    assert K.launches == before, "CPU tensors never launch the kernel"
    (_unit, kind, fns), = c._fn.steps
    assert kind == "cuda"
    arrays = {k: torch.from_numpy(v) for k, v in _inputs(prog).items()}
    with pytest.raises(ValueError):
        fns[0]({**arrays, "R": torch.zeros(1)})  # wrong shape: refused, not guessed


# --------------------------------------------------------- postfix compiler
class _NumpyOps:
    """A plain evaluator: numpy arrays, the framework tables' semantics."""

    UNARY = {"neg": np.negative, "exp": np.exp, "log": np.log, "tanh": np.tanh,
             "sqrt": np.sqrt, "rsqrt": lambda a: 1 / np.sqrt(a),
             "sigmoid": lambda a: 1 / (1 + np.exp(-a)), "relu": lambda a: np.maximum(a, 0),
             "abs": np.abs, "square": np.square,
             "erf": np.vectorize(math.erf),
             "gelu": lambda a: 0.5 * a * (1 + np.vectorize(math.erf)(a / math.sqrt(2))),
             "silu": lambda a: a / (1 + np.exp(-a)), "sign": np.sign, "floor": np.floor,
             "cast": lambda a: a}
    BINARY = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide,
              "max": np.maximum, "min": np.minimum, "pow": np.power}

    def const(self, v):
        return np.float64(v)

    def unary(self, name, x):
        return self.UNARY[name](x)

    def binary(self, name, a, b):
        return self.BINARY[name](a, b)


def _eval_tnode(n, tiles):
    if n.kind == "load":
        return tiles[n.buf]
    if n.kind == "const":
        return np.float64(n.value)
    args = [_eval_tnode(a, tiles) for a in n.args]
    if len(args) == 1:
        return _NumpyOps.UNARY[n.op](args[0])
    return _NumpyOps.BINARY[n.op](*args)


def _all_ops_dag():
    T = LC._TNode
    x, y = T("load", buf="X"), T("load", buf="Y")
    node = T("op", op="add", args=(x, T("const", value=0.5)))
    for op in K.UNARY_OPS:
        if op in ("log", "sqrt", "rsqrt"):
            node = T("op", op=op, args=(T("op", op="abs", args=(node,)),))
            node = T("op", op="add", args=(node, T("const", value=1.5)))
        else:
            node = T("op", op=op, args=(node,))
    for op in K.BINARY_OPS:
        node = T("op", op=op, args=(node, T("op", op="abs", args=(y,)) if op == "pow" else y))
    return node


def test_postfix_program_evaluates_like_its_dag():
    rng = np.random.RandomState(5)
    tiles = {"X": rng.rand(7) + 0.5, "Y": rng.rand(7) + 0.5}
    dag = _all_ops_dag()
    pf = LC._Postfix()
    prog = pf.tnode(dag, {"X": 0, "Y": 1})
    assert {c for c, _ in prog} >= {K.OP_UNARY + i for i in range(len(K.UNARY_OPS))}
    got = K.run_postfix(tuple(prog), [tiles["X"], tiles["Y"]], None, pf.consts, _NumpyOps())
    np.testing.assert_allclose(got, _eval_tnode(dag, tiles), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_postfix_programs_of_extracted_plans(name):
    """Every prologue and epilogue DAG of the test programs compiles to a
    postfix program that evaluates to the DAG's value."""
    _jb, tbuild = PROGRAMS[name]
    rng = np.random.RandomState(6)
    for _jblk, tb in _opt_blocks("tpu_v5e", _jb(), tbuild()):
        try:
            plan = LC.extract_contraction(LC._ensure_grid(tb))
        except LC.UnsupportedCuda:
            continue
        pf = LC._Postfix()
        for side in (plan.lhs, plan.rhs):
            names = sorted({ld.buf for ld in side.loads()})
            tiles = {n: rng.randn(5) for n in names}
            prog = tuple(pf.tnode(side, {n: i for i, n in enumerate(names)}))
            got = K.run_postfix(prog, [tiles[n] for n in names], None, pf.consts, _NumpyOps())
            np.testing.assert_allclose(got, _eval_tnode(side, tiles), rtol=1e-12)
        if plan.epilogue:
            from repro_torch.core.ir import Load
            names = sorted({s.buf for s in plan.epilogue
                            if isinstance(s, Load) and s.into != plan.acc_scalar})
            tiles = {n: rng.randn(5) for n in names}
            acc = rng.randn(5)
            prog = tuple(pf.epilogue(plan.epilogue, plan.acc_scalar,
                                     {n: i for i, n in enumerate(names)}))
            got = K.run_postfix(prog, [tiles[n] for n in names], acc, pf.consts, _NumpyOps())
            env = {}
            want = acc
            for s in plan.epilogue:
                kind = type(s).__name__
                if kind == "Load":
                    env[s.into] = acc if s.into == plan.acc_scalar else tiles[s.buf]
                elif kind == "Constant":
                    env[s.into] = np.float64(s.value)
                elif kind == "Intrinsic":
                    a = [env[x] for x in s.args]
                    env[s.into] = (_NumpyOps.UNARY[s.op](a[0]) if len(a) == 1
                                   else _NumpyOps.BINARY[s.op](*a))
                elif kind == "Store":
                    want = env[s.scalar]
            np.testing.assert_allclose(got, want, rtol=1e-12)
