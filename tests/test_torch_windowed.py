"""The windowed emitter of the port against the JAX package's: every case
of ``tests/test_halo_pallas.py`` through ``repro_torch``'s ``cuda`` backend
(the windowed kernel's plain version on CPU tensors), held against the
reference's ``pallas`` backend in interpret mode and against the exact
reference interpreter.

Tolerances: the int8 convolution bit-exact; float32 within rtol 1e-4 /
atol 1e-4 (sums of up to 72 terms in another order), as the reference's
own tests hold its Pallas kernels.  The kernel-level tests at the end hold
the three plain versions against independent PyTorch formulas.
"""
import copy

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import TileProgram as JTile  # noqa: E402
from repro.core import execute_reference  # noqa: E402
from repro.core import stripe_jit as j_jit  # noqa: E402
from repro.core.frontend import single_op_program as j_single  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.core.tiling import split_block as j_split  # noqa: E402
from repro.core.passes.boundary import split_boundary as j_boundary  # noqa: E402

from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram as TTile  # noqa: E402
from repro_torch.core.frontend import single_op_program as t_single  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.core.lower_cuda import lower_program_hybrid  # noqa: E402
from repro_torch.core.passes.boundary import _n_constraints  # noqa: E402
from repro_torch.core.passes.boundary import split_boundary as t_boundary  # noqa: E402
from repro_torch.core.tiling import split_block as t_split  # noqa: E402
from repro_torch.explore.workloads import resnet50_conv2_3x3  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402
from repro_torch.kernels import elementwise as EW  # noqa: E402
from repro_torch.kernels import windowed as WK  # noqa: E402


def _conv_prog(single, x, y, c, k, f, dtype="float32", name="conv"):
    pad = f // 2
    return single(
        f"O[x, y, k] += I[x + i - {pad}, y + j - {pad}, c] * F[i, j, c, k]",
        {"I": ((x, y, c), dtype), "F": ((f, f, c, k), dtype),
         "O": ((x, y, k), dtype if dtype != "int8" else "int32")},
        out="O", name=name)


def _conv_inputs(prog, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for n in prog.inputs:
        d = prog.buffers[n]
        if d.dtype == "int8":
            out[n] = rng.randint(-4, 5, d.shape).astype(np.int8)
        else:
            out[n] = rng.randn(*d.shape).astype(np.float32)
    return out


def _port(prog, hw="tpu_v5e"):
    return t_jit(prog, t_hw(hw), "cuda", cache=t_cache.CompilationCache(use_disk=False),
                 use_disk=False)


def _pallas(prog, hw="tpu_v5e"):
    return j_jit(prog, j_hw(hw), backend="pallas", interpret=True, use_disk=False)


def _run_port(compiled, ins):
    return {k: v.numpy() for k, v in compiled({k: torch.from_numpy(v)
                                               for k, v in ins.items()}).items()}


def _kernels(compiled):
    return [fn.kernel for _u, kind, fns in compiled._fn.steps if kind == "cuda" for fn in fns]


def _hold(got, pallas, ref, exact=False):
    if exact:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(pallas))
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- fig4 / fig5
@pytest.mark.parametrize("name", ["fig5_conv_f32", "fig4_conv"])
def test_paper_conv_lowers_to_the_windowed_kernel(name):
    """The paper's conv (float32 fig5, int8 fig4 bit-exact) runs every unit
    on the windowed kernel, with no fallback, and matches the reference's
    Pallas kernels and its interpreter."""
    from repro.explore import workloads as jw
    from repro_torch.explore import workloads as tw

    jprog, tprog = getattr(jw, name)(), getattr(tw, name)()
    src = copy.deepcopy(jprog)
    jc, tc = _pallas(jprog), _port(tprog)
    rec = tc.record
    assert rec.backend == "cuda", rec.fallback_reason
    assert rec.n_kernels == jc.record.n_kernels >= 1
    assert set(rec.block_backends.values()) == {"cuda"}
    assert rec.fallback_reasons() == {}
    assert set(_kernels(tc)) == {"windowed"}
    ins = _conv_inputs(src, 1 if name == "fig4_conv" else 0)
    got = _run_port(tc, ins)["O"]
    _hold(got, jc(ins)["O"], execute_reference(src, ins)["O"], exact=name == "fig4_conv")


# ------------------------------------------------------- a split window
def _j_config(name):
    """The reference's ``HardwareConfig`` with the port's config's values
    (the reference has no ``h100``)."""
    import dataclasses

    from repro.core import hwconfig as jh

    t = t_hw(name)
    return jh.HardwareConfig(**{
        f.name: getattr(t, f.name) for f in dataclasses.fields(t)
        if f.name not in ("mem_units", "stencils")},
        mem_units=tuple(jh.MemoryUnit(**dataclasses.asdict(m)) for m in t.mem_units),
        stencils=tuple(jh.ComputeStencil(**dataclasses.asdict(c)) for c in t.stencils))


@pytest.mark.parametrize("hw,k", [("h100", 8), ("h100", 16), ("tpu_v5e", 64)])
def test_a_split_window_joins_into_one_launch_a_region(hw, k):
    """A 56 x 56 x 64 conv whose tiling cuts the 3-tap window 2 + 1 (the
    channel shard of ResNet-50 conv2_x on 4 ranks under h100, and the whole
    layer under tpu_v5e): the reference's windowed emitter refuses the
    input offset (``2*i + 8*x - 1``) and runs the unit on ``jnp``; the port
    takes it, joins the boundary pass's two pieces of each output region
    into one launch over the 3 taps, which takes the igemm path, and
    matches the reference's ``jnp`` backend at the file's float32
    tolerance."""
    jprog = _conv_prog(j_single, 56, 56, 64, k, 3)
    tprog = _conv_prog(t_single, 56, 56, 64, k, 3)
    src = copy.deepcopy(jprog)
    jrec = j_jit(copy.deepcopy(jprog), _j_config(hw), backend="pallas", interpret=True,
                 use_disk=False).record
    assert jrec.block_backends == {"op0": "jnp"}
    assert "unsupported offset" in jrec.fallback_reasons()["op0"]
    tc = _port(tprog, hw)
    assert list(tc.record.tilings.values())[0]["i"] == 2
    assert tc.record.block_backends == {"op0": "cuda"} and tc.record.fallback_reasons() == {}
    assert _kernels(tc) == ["windowed", "windowed"] and tc.record.n_kernels == 2
    for _u, _kind, fns in tc._fn.steps:
        for fn in fns:
            plan = fn.plan
            assert [e for v, e in zip(plan.red_vars, plan.red_ext) if v.startswith("1:i")] == [3]
            assert WK.plan_path(plan) == "igemm", WK.refusal(plan)
    ins = _conv_inputs(src)
    want = j_jit(src, _j_config(hw), backend="jnp", use_disk=False)(ins)["O"]
    np.testing.assert_allclose(_run_port(tc, ins)["O"], np.asarray(want), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------- partition properties
@settings(max_examples=4, deadline=None)
@given(st.integers(5, 10), st.integers(4, 9), st.integers(1, 2),
       st.integers(1, 2), st.sampled_from([2, 3]), st.integers(2, 4),
       st.sampled_from(["remainder", "edges"]))
def test_boundary_pieces_lower_and_partition_the_conv(x, y, c, k, f, tile, mode):
    """The boundary pieces of a tiled conv (non-dividing tiles included)
    lower to the port's kernels and reproduce the unsplit conv."""
    prog = _conv_prog(t_single, x, y, c, k, f)
    jsrc = _conv_prog(j_single, x, y, c, k, f)
    blk = prog.entry.stmts[0]
    pieces = t_boundary(t_split(blk, {"x": tile, "y": tile}), mode=mode, max_splits=4)
    jpieces = j_boundary(j_split(jsrc.entry.stmts[0], {"x": tile, "y": tile}),
                         mode=mode, max_splits=4)
    assert [p.name for p in pieces] == [p.name for p in jpieces]
    prog.source = copy.deepcopy(prog)
    prog.entry.stmts = list(pieces)
    fn = lower_program_hybrid(prog)
    assert fn.n_cuda == len(pieces)
    ins = _conv_inputs(jsrc, seed=x * 100 + y * 10 + f)
    got = fn({k_: torch.from_numpy(v) for k_, v in ins.items()})["O"].numpy()
    np.testing.assert_allclose(got, execute_reference(jsrc, ins)["O"], rtol=1e-4, atol=1e-4)


def test_per_index_budget_splits_both_conv_axes_and_lowers():
    """Every constraint-carrying grid axis is split (the port's boundary
    pass names the same pieces as the reference's), the interior is
    constraint-free, and the pieces lower to the kernels and match the
    reference interpreter."""
    prog = _conv_prog(t_single, 32, 32, 2, 2, 3, name="conv2d")
    jsrc = _conv_prog(j_single, 32, 32, 2, 2, 3, name="conv2d")
    pieces = t_boundary(t_split(prog.entry.stmts[0], {"x": 8, "y": 8}), mode="edges",
                        max_splits=4)
    jpieces = j_boundary(j_split(jsrc.entry.stmts[0], {"x": 8, "y": 8}), mode="edges",
                         max_splits=4)
    assert [p.name for p in pieces] == [p.name for p in jpieces]
    split_axes = {seg[0] for p in pieces for seg in p.name.split(".")
                  if len(seg) > 1 and seg[0] in "xy" and seg[1:].isdigit()}
    assert {"x", "y"} <= split_axes
    interior = [p for p in pieces if "interior" in p.tags]
    assert interior and all(_n_constraints(p) == 0 for p in interior)
    prog.source = copy.deepcopy(prog)
    prog.entry.stmts = list(pieces)
    fn = lower_program_hybrid(prog)
    assert fn.n_cuda == len(pieces)
    ins = _conv_inputs(jsrc, seed=2)
    got = fn({k: torch.from_numpy(v) for k, v in ins.items()})["O"].numpy()
    np.testing.assert_allclose(got, execute_reference(jsrc, ins)["O"], rtol=1e-4, atol=1e-4)


def _mmrem(tile_cls):
    tp = tile_cls("mmrem")
    tp.input("A", (12, 8))
    tp.input("B", (8, 16))
    tp.output("O", (12, 16))
    tp.op("O[m, n] += A[m, c] * B[c, n]", name="mm")
    return tp.build()


def test_masked_remainder_non_dividing_tile():
    """A matmul tiled 8 over m = 12: the interior piece lowers on the
    contraction kernel, the overflow remainder on the windowed kernel's
    masked store, and the composed kernels match the reference's Pallas
    kernels and its interpreter."""
    from repro.core.lower_pallas import lower_program_hybrid as j_hybrid

    prog, jprog = _mmrem(TTile), _mmrem(JTile)
    src = copy.deepcopy(jprog)
    pieces = t_boundary(t_split(prog.entry.stmts[0], {"m": 8}))
    jpieces = j_boundary(j_split(jprog.entry.stmts[0], {"m": 8}))
    assert any("interior" in p.tags for p in pieces)
    assert any("boundary" in p.tags for p in pieces)
    prog.entry.stmts, jprog.entry.stmts = list(pieces), list(jpieces)
    prog.source, jprog.source = copy.deepcopy(_mmrem(TTile)), copy.deepcopy(src)
    fn = lower_program_hybrid(prog)
    assert fn.n_cuda == len(pieces)  # both pieces are real kernels
    kinds = [f.kernel for _u, _k, fns in fn.steps for f in fns]
    assert sorted(kinds) == ["contraction", "windowed"]
    ins = {"A": np.random.RandomState(3).randn(12, 8).astype(np.float32),
           "B": np.random.RandomState(4).randn(8, 16).astype(np.float32)}
    got = fn({k: torch.from_numpy(v) for k, v in ins.items()})["O"].numpy()
    want = j_hybrid(jprog, interpret=True)(ins)["O"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, execute_reference(src, ins)["O"], rtol=1e-4, atol=1e-5)


@settings(max_examples=3, deadline=None)
@given(st.integers(4, 8), st.integers(4, 8), st.integers(1, 3),
       st.integers(1, 3), st.sampled_from([2, 3]))
def test_property_conv_through_the_port_matches_pallas(x, y, c, k, f):
    """Random conv shapes through the full tpu_v5e pipeline: the port's
    kernels (plain versions) equal the reference's Pallas kernels and its
    interpreter."""
    jprog = _conv_prog(j_single, x, y, c, k, f)
    src = copy.deepcopy(jprog)
    jc, tc = _pallas(jprog), _port(_conv_prog(t_single, x, y, c, k, f))
    assert tc.record.backend == "cuda", tc.record.fallback_reason
    assert set(tc.record.block_backends.values()) == {"cuda"}
    ins = _conv_inputs(src, seed=x * 1000 + y * 100 + c * 10 + f)
    _hold(_run_port(tc, ins)["O"], jc(ins)["O"], execute_reference(src, ins)["O"])


# ------------------------------------------------------- per-block hybrid
def _mixed_prog(tile_cls):
    tp = tile_cls("mixed")
    tp.input("A", (16, 8))
    tp.input("B", (8, 16))
    tp.temp("T", (16, 16))
    tp.output("O2", (16, 16))
    tp.output("M", (16,))
    tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm")
    tp.op("O2[i, j] = gelu(T[i, j])", name="act")
    tp.op("M[i] max= T[i, j]", name="rowmax")  # max-agg: no kernel path
    return tp.build()


def test_hybrid_keeps_kernels_next_to_the_torch_unit():
    """``rowmax`` (a max= aggregation) stays on torch with both attempted
    paths' reasons, exactly the reference's; every other unit is on the
    kernels."""
    jc, tc = _pallas(_mixed_prog(JTile)), _port(_mixed_prog(TTile))
    rec = tc.record
    assert rec.backend == "cuda"
    assert rec.block_backends["rowmax"] == "torch"
    assert {u: b for u, b in rec.block_backends.items() if u != "rowmax"} == \
        {u: "cuda" for u in jc.record.block_backends if u != "rowmax"}
    reason = rec.fallback_reasons()["rowmax"]
    assert "contraction:" in reason and "windowed:" in reason
    assert reason == jc.record.fallback_reasons()["rowmax"]
    ins = {"A": np.random.RandomState(0).randn(16, 8).astype(np.float32),
           "B": np.random.RandomState(1).randn(8, 16).astype(np.float32)}
    got = _run_port(tc, ins)
    want = execute_reference(_mixed_prog(JTile), ins)
    for out in ("O2", "M"):
        np.testing.assert_allclose(got[out], want[out], rtol=1e-4, atol=1e-5)


def _twowrite(tile_cls):
    tp = tile_cls("twowrite")
    for n, shape in (("A", (8, 4)), ("B", (4, 8)), ("C", (8, 4)), ("D", (4, 8))):
        tp.input(n, shape)
    tp.output("O", (8, 8))
    tp.op("O[i, j] += A[i, k] * B[k, j]", name="mm1")
    tp.op("O[i, j] += C[i, k] * D[k, j]", name="mm2")
    return tp.build()


def test_two_accumulating_writers_refuse_hybrid_and_aggregate():
    """Two ``+=`` writers into one buffer: the composer refuses (the whole
    program falls back to torch, reason recorded), and the torch path
    aggregates the second writer instead of clobbering the first."""
    src = _twowrite(JTile)
    rng = np.random.RandomState(7)
    ins = {n: rng.randn(*src.buffers[n].shape).astype(np.float32) for n in src.inputs}
    tc = _port(_twowrite(TTile))
    assert tc.record.backend == "torch"
    assert "writes to O" in tc.record.fallback_reason or "write O" in tc.record.fallback_reason
    np.testing.assert_allclose(_run_port(tc, ins)["O"], execute_reference(src, ins)["O"],
                               rtol=1e-4, atol=1e-5)


def test_whole_program_fallback_still_records_reason():
    def prog(tile_cls):
        tp = tile_cls("allmax")
        tp.input("X", (8, 8))
        tp.output("M", (8,))
        tp.op("M[i] max= X[i, j]", name="colmax")
        return tp.build()

    jrec, trec = _pallas(prog(JTile)).record, _port(prog(TTile)).record
    assert trec.backend == "torch" and jrec.backend == "jnp"
    assert trec.block_backends == {"colmax": "torch"}
    assert trec.fallback_reasons() == jrec.fallback_reasons()


def test_memplan_prices_halo_slots_as_the_reference():
    from repro.core import memplan as j_memplan
    from repro.core.passes import PassManager as JPM
    from repro_torch.core import memplan as t_memplan
    from repro_torch.core.passes import PassManager as TPM

    plans = []
    for single, pm, hw, mp in ((j_single, JPM, j_hw, j_memplan), (t_single, TPM, t_hw, t_memplan)):
        opt = pm(hw("tpu_v5e")).run(_conv_prog(single, 12, 16, 8, 16, 3, name="fig5"))
        grids = [s for s in opt.entry.stmts if isinstance(s, type(opt.entry)) and "grid" in s.tags]
        plan = mp.plan_block(grids[0], depth=2)
        plans.append((plan.halo_bytes, sorted((a.view.kind, a.view.halo_bytes)
                                              for a in plan.allocs)))
    assert plans[1] == plans[0] and plans[1][0] > 0
    assert any(kind == "halo" and hb == (10 * 18 * 8 - 8 * 18 * 8) * 4
               for kind, hb in plans[1][1])


def test_autotile_charges_halo_traffic_as_the_reference():
    from repro.core.cost import evaluate_tiling as j_eval
    from repro_torch.core.cost import evaluate_tiling as t_eval

    got = []
    for single, ev, hw in ((j_single, j_eval, j_hw), (t_single, t_eval, t_hw)):
        blk = _conv_prog(single, 64, 64, 4, 8, 3, name="conv64").entry.stmts[0]
        h = hw("tpu_v5e")
        params = dict(h.passes[1][1])
        got.append([ev(blk, {"x": t, "y": t}, h, params).halo_bytes for t in (4, 16)])
    assert got[1] == got[0] and got[1][0] > got[1][1] > 0


# ------------------------------------------------ plain versions, by formula
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_windowed_plain_is_a_padded_conv(dtype):
    """The windowed kernel's plain version on a ResNet-shaped conv
    (batch 1, 56x56, 64 channels) against ``conv2d`` in float64: int8
    bit-exact, float32 within 1e-4 of the largest output, bf16 within one
    bf16 rounding step (2**-8) of it."""
    prog = resnet50_conv2_3x3(batch=1, dtype=dtype)
    c = t_jit(prog, t_hw("h100"), "cuda", cache=t_cache.CompilationCache(use_disk=False),
              use_disk=False)
    assert set(_kernels(c)) == {"windowed"}
    from repro_torch.explore.runner import _random_arrays

    env = _random_arrays(c.program.source, seed=4, device="cpu")
    got = c(env)["O"]
    x = env["I"].permute(0, 3, 1, 2).double()
    w = env["F"].permute(3, 2, 0, 1).double()
    want = torch.nn.functional.conv2d(x, w, padding=1).permute(0, 2, 3, 1)
    if dtype == "int8":
        assert got.dtype == torch.int32 and torch.equal(got.double(), want)
    else:
        tol = 1e-4 if dtype == "float32" else 2 ** -8
        assert (got.double() - want).abs().max().item() <= tol * want.abs().max().item()


def test_contraction_plain_accumulates_int8_in_int32():
    """int8 operands whose products overflow int8 and whose sums overflow
    int16: the plain version accumulates in int32 exactly."""
    tp = TTile("mm8")
    tp.input("A", (16, 300), "int8")
    tp.input("B", (300, 8), "int8")
    tp.output("O", (16, 8), "int32")
    tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    c = t_jit(tp.build(), t_hw("h100"), "cuda",
              cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    assert _kernels(c) == ["contraction"]
    a = torch.full((16, 300), 127, dtype=torch.int8)
    b = torch.full((300, 8), -128, dtype=torch.int8)
    got = c({"A": a, "B": b})["O"]
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.full((16, 8), 127 * -128 * 300, dtype=torch.int32))


def test_integer_units_refuse_ops_not_closed_over_integers():
    tp = TTile("intdiv")
    tp.input("A", (8, 8), "int32")
    tp.output("O", (8, 8), "int32")
    tp.op("O[i, j] = exp(A[i, j])", name="e")
    rec = t_jit(tp.build(), t_hw("h100"), "cuda",
                cache=t_cache.CompilationCache(use_disk=False), use_disk=False).record
    assert rec.block_backends == {"e": "torch"}
    assert "on integers" in rec.fallback_reasons()["e"]


def test_elementwise_plain_broadcasts_lower_rank_inputs():
    tp = TTile("bcast")
    tp.input("X", (3, 5, 7), "bfloat16")
    tp.input("b", (7,))
    tp.output("O", (3, 5, 7), "bfloat16")
    tp.op("O[n, i, j] = relu(X[n, i, j] * b[j]) + 0.5", name="map")
    c = t_jit(tp.build(), t_hw("h100"), "cuda",
              cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    assert _kernels(c) == ["elementwise"]
    (_u, _k, (fn,)), = c._fn.steps
    assert fn.plan.ins[1].ostride.count(0) == 2  # b broadcasts over n and i
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 5, 7).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(7).astype(np.float32))
    got = c({"X": x, "b": b})["O"]
    want = (torch.relu(x.float() * b) + 0.5).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_wrappers_refuse_mismatched_devices_and_types():
    """On the CPU the wrappers run the plain versions; a tensor of another
    type than planned, or tensors split over devices, is refused rather
    than converted."""
    with pytest.raises(ValueError):
        EW.elementwise(EW.MapPlan(out_vars=(), out_ext=(), out_dim=(), out_coef=(),
                                  out_shape=(), ins=(), prog=(), consts=()), [])
    with pytest.raises(ValueError):
        WK.windowed(None, [])
    tp = TTile("mm")
    tp.input("A", (4, 4))
    tp.input("B", (4, 4))
    tp.output("O", (4, 4))
    tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    c = t_jit(tp.build(), t_hw("h100"), "cuda",
              cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    (_u, _k, (fn,)), = c._fn.steps
    a = torch.ones(4, 4)
    before = K.launches
    assert torch.equal(fn({"A": a, "B": a}), torch.full((4, 4), 4.0))
    assert K.launches == before  # the CPU path never counts a launch
    with pytest.raises(TypeError):
        K.contraction(fn.plan, [a.cuda() if torch.cuda.is_available() else a.double(), a], [])
