"""Tests that need an NVIDIA card: the CUDA kernels (contraction,
elementwise, windowed, flash attention, chunked GLA) against their plain
PyTorch versions.  They skip
without a card.  On a machine with one (and no JAX), run them alone,
without the JAX package's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import lower_cuda as LC  # noqa: E402
from repro_torch.core.driver import stripe_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram  # noqa: E402
from repro_torch.core.frontend import single_op_program  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.explore.runner import _random_arrays  # noqa: E402
from repro_torch.explore.workloads import get_workloads, resnet50_conv2_3x3  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402
from repro_torch.kernels import elementwise as EW  # noqa: E402
from repro_torch.kernels import windowed as WK  # noqa: E402
from repro_torch.kernels.stripe_matmul import matmul, matmul_ref  # noqa: E402

KERNELS = {"contraction": K, "elementwise": EW, "windowed": WK}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _programs():
    chain = TileProgram("chain")
    chain.input("A", (16, 12)); chain.input("B", (12, 24)); chain.input("b", (24,))
    chain.temp("T", (16, 24)); chain.temp("U", (16, 24)); chain.output("G", (16, 24))
    chain.op("T[i, j] += A[i, c] * B[c, j]", name="mm1")
    chain.op("U[i, j] = T[i, j] + b[j]", name="bias")
    chain.op("G[i, j] = gelu(U[i, j])", name="act")
    pro = TileProgram("pro")
    pro.input("X", (16, 12)); pro.input("W", (12, 24))
    pro.temp("X2", (16, 12)); pro.output("O", (16, 24))
    pro.op("X2[i, c] = gelu(X[i, c])", name="pre")
    pro.op("O[i, j] += X2[i, c] * W[c, j]", name="mm")
    gqa = TileProgram("scores")
    gqa.input("Q", (3, 2, 2, 16)); gqa.input("K", (3, 40, 2, 16)); gqa.output("S", (3, 2, 2, 40))
    gqa.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    return {"chain": chain, "prologue": pro, "scores": gqa}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", ["h100", "tpu_v5e", "cpu_test"])
@pytest.mark.parametrize("name", ["chain", "prologue", "scores"])
def test_kernel_matches_plain_on_the_card(name, hw):
    _card()
    prog = _programs()[name].build()
    c = stripe_jit(prog, get_config(hw), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    rng = np.random.RandomState(7)
    env = {k: torch.from_numpy(rng.randn(*prog.buffers[k].shape).astype(np.float32)).cuda()
           for k in prog.inputs}
    before = K.launches
    for _unit, kind, fns in c._fn.steps:
        if kind != "cuda":
            env.update(fns(env))
            continue
        for fn in fns:
            got, want = fn(env), fn.plain(env)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            env[fn.out_buf] = LC._place(env, prog.buffers[fn.out_buf], fn, got)
    assert K.launches > before


@pytest.mark.cuda
def test_stripe_matmul_kernel_on_the_card():
    _card()
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(64, 96).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.randn(96, 32).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(32).astype(np.float32)).cuda()
    before = K.launches
    got = matmul(x, w, b, act="silu")
    assert K.launches == before + 1
    torch.testing.assert_close(got, matmul_ref(x, w, b, act="silu"), rtol=1e-5, atol=1e-5)


def _assert_kernel_close(got, want, what):
    """Kernel against plain, by output type: integers exactly; float32
    within 1e-4 of the largest output (sums in another order); 16-bit
    floats within 2e-2 of it (both round the same float32 result once; the
    summation orders can move that result across one rounding step, at
    most 2**-8 = 3.9e-3 of the element)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if not got.dtype.is_floating_point:
        assert torch.equal(got, want), what
        return
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), what
    tol = 1e-4 if got.dtype == torch.float32 else 2e-2
    err = (g - w).abs().max().item()
    assert err <= tol * (1 + w.abs().max().item()), (what, err)


def _units_against_plain(c, env):
    """Run every unit of a compiled program: each kernel against its plain
    version on the same inputs.  Returns the kernels that ran."""
    ran = set()
    for unit, kind, fns in c._fn.steps:
        assert kind == "cuda", unit.name
        for fn in fns:
            mod = KERNELS[fn.kernel]
            before = mod.launches
            got, want = fn(env), fn.plain(env)
            torch.cuda.synchronize()
            assert mod.launches == before + 1
            _assert_kernel_close(got, want, f"{unit.name} ({fn.kernel})")
            env[fn.out_buf] = LC._place(env, c.program.buffers[fn.out_buf], fn, got)
            ran.add(fn.kernel)
    return ran


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "no-fuse"])
@pytest.mark.parametrize("name", ["mm_bias_gelu", "ffn_relu2", "attn_scores", "moe_ffn",
                                  "fig4_conv", "fig5_conv_f32", "conv_mlp"])
def test_corpus_units_kernel_matches_plain_on_the_card(name, fuse):
    _card()
    hw = get_config("h100") if fuse else get_config("h100").without_pass("fuse")
    prog = {w.name: w for w in get_workloads("all")}[name].build()
    c = stripe_jit(prog, hw, "cuda", cache=t_cache.CompilationCache(use_disk=False),
                   use_disk=False)
    assert set(c.record.block_backends.values()) == {"cuda"}, c.record.fallback_reasons()
    ran = _units_against_plain(c, _random_arrays(c.program.source, seed=3))
    if name in ("fig4_conv", "fig5_conv_f32", "conv_mlp"):
        assert "windowed" in ran
    if not fuse and name in ("mm_bias_gelu", "ffn_relu2", "moe_ffn"):
        assert "elementwise" in ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_resnet_conv_on_the_windowed_kernel(dtype):
    """ResNet-50's conv2_x 3x3 layer at batch 2: every piece on the
    windowed kernel, held against its plain version, and the whole layer
    against ``conv2d`` in float64 (int8: bit-exact)."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    prog = resnet50_conv2_3x3(batch=2, dtype=dtype)
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c.program.source, seed=4)
    assert _units_against_plain(c, dict(env)) == {"windowed"}
    got = c(env)["O"]
    x = env["I"].permute(0, 3, 1, 2).double()
    w = env["F"].permute(3, 2, 0, 1).double()
    want = torch.nn.functional.conv2d(x, w, padding=1).permute(0, 2, 3, 1)
    if dtype == "int8":
        assert got.dtype == torch.int32 and torch.equal(got.double(), want)
    else:
        _assert_kernel_close(got, want.to(got.dtype), "resnet conv vs conv2d")


def _conv_program(b, x, y, c, k, dtype):
    out = "int32" if dtype == "int8" else dtype
    return single_op_program(
        "O[n, x, y, k] += I[n, x + i - 1, y + j - 1, c] * F[i, j, c, k]",
        {"I": ((b, x, y, c), dtype), "F": ((3, 3, c, k), dtype), "O": ((b, x, y, k), out)},
        out="O", name=f"conv_{b}x{x}x{y}x{c}x{k}_{dtype}")


def _windowed_paths_against_plain(prog):
    """Every windowed unit of ``prog`` under h100 against its plain
    version, launched twice (bit-identical), and the path each took
    (read from ``launches_by_path``)."""
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c.program.source, seed=8)
    paths = []
    for unit, kind, fns in c._fn.steps:
        assert kind == "cuda", unit.name
        for fn in fns:
            before = dict(WK.launches_by_path)
            got = fn(env)
            again = fn(env)
            want = fn.plain(env)
            torch.cuda.synchronize()
            ran = [p for p in WK.PATHS if WK.launches_by_path[p] == before[p] + 2]
            assert ran == [WK.plan_path(fn.plan)], (before, WK.launches_by_path)
            paths.append(ran[0])
            assert torch.equal(got, again), f"{unit.name}: a relaunch differs"
            _assert_kernel_close(got, want, f"{unit.name} ({ran[0]})")
            env[fn.out_buf] = LC._place(env, c.program.buffers[fn.out_buf], fn, got)
    return paths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("batch", [1, 2])
def test_windowed_igemm_resnet_units_on_the_card(batch, dtype):
    """ResNet-50's conv2_x units take the igemm path (wgmma for bf16 and
    int8, the CUDA cores for float32) and agree with their plain versions:
    int8 bit-exact."""
    _card()
    paths = _windowed_paths_against_plain(resnet50_conv2_3x3(batch, dtype))
    assert len(paths) >= 2 and set(paths) == {"igemm"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
@pytest.mark.parametrize("shape", [(2, 13, 21, 32, 40), (1, 9, 70, 64, 136)],
                         ids=["ragged-n", "three-n-tiles"])
def test_windowed_igemm_ragged_convs_on_the_card(shape, dtype):
    """Ragged spatial sizes, 32 channels (a K stage spans two taps), N
    below one tile and over two, remainders over N whose filter columns
    end inside the tile: every unit on igemm, against plain."""
    _card()
    paths = _windowed_paths_against_plain(_conv_program(*shape, dtype))
    assert paths and set(paths) == {"igemm"}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 16])
def test_windowed_split_window_joined_on_the_card(k):
    """56 x 56 x 64 -> k under h100, whose tiling cuts the 3-tap window
    2 + 1 (ResNet-50 conv2_x's channel shard on 4 ranks): one launch a
    region over the 3 taps, on igemm, against plain."""
    _card()
    paths = _windowed_paths_against_plain(_conv_program(1, 56, 56, 64, k, "float32"))
    assert paths == ["igemm", "igemm"]


@pytest.mark.cuda
def test_windowed_refused_plan_runs_general_on_the_card():
    """fig4's int8 conv has 8 channels (8 bytes, not a 16-byte copy): the
    view refuses it, with its reason, and the general loop runs it."""
    _card()
    prog = {w.name: w for w in get_workloads("all")}["fig4_conv"].build()
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    plans = [fn.plan for _u, _k, fns in c._fn.steps for fn in fns if fn.kernel == "windowed"]
    assert plans and all("16-byte copies" in WK.refusal(p) for p in plans)
    assert set(_windowed_paths_against_plain(prog)) == {"general"}


@pytest.mark.cuda
def test_windowed_misaligned_input_runs_general_on_the_card():
    """An input that starts off a 16-byte boundary: each launch classifies
    with its tensors' own alignment, so units that take igemm on aligned
    tensors run the general loop, and ``refusal`` with ``input_alignment``
    of the same tensors names the reason."""
    _card()
    c = stripe_jit(_conv_program(1, 10, 12, 64, 64, "bfloat16"), get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c.program.source, seed=8)
    shifted = torch.empty(env["I"].numel() + 1, dtype=env["I"].dtype, device="cuda")
    env["I"] = shifted[1:].view(env["I"].shape).copy_(env["I"])
    fns = [fn for _u, _k, fs in c._fn.steps for fn in fs if fn.kernel == "windowed"]
    assert fns
    for fn in fns:
        aligned = WK.input_alignment([env[i.buf] for i in fn.plan.ins])
        assert WK.plan_path(fn.plan) == "igemm"
        assert WK.plan_path(fn.plan, aligned) == "general"
        assert "16-byte boundaries" in WK.refusal(fn.plan, aligned)
        before = dict(WK.launches_by_path)
        got = fn(env)
        want = fn.plain(env)
        torch.cuda.synchronize()
        assert WK.launches_by_path == {"igemm": before["igemm"],
                                       "general": before["general"] + 1}
        _assert_kernel_close(got, want, f"{fn.plan.out_ext} (general, misaligned)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_windowed_general_path_argument_on_the_card(dtype):
    """``path="general"`` runs the odometer loop on an igemm unit: the
    two agree (int8 exactly), and each counts under its own path."""
    _card()
    c = stripe_jit(_conv_program(1, 10, 12, 64, 64, dtype), get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c.program.source, seed=9)
    fn = next(fn for _u, _k, fns in c._fn.steps for fn in fns)
    ins = [env[i.buf] for i in fn.plan.ins]
    before = dict(WK.launches_by_path)
    got = WK.windowed(fn.plan, ins, fn.out_clip)
    gen = WK.windowed(fn.plan, ins, fn.out_clip, path="general")
    torch.cuda.synchronize()
    assert WK.launches_by_path == {"igemm": before["igemm"] + 1,
                                   "general": before["general"] + 1}
    _assert_kernel_close(got, gen, "igemm against general")


@pytest.mark.cuda
def test_elementwise_broadcasts_and_rounds_on_the_card():
    _card()
    tp = TileProgram("bcast")
    tp.input("X", (4, 33, 70), "bfloat16"); tp.input("b", (70,)); tp.input("s", (33, 1))
    tp.output("O", (4, 33, 70), "bfloat16")
    tp.op("O[n, i, j] = silu(X[n, i, j] + b[j]) * s[i, 0]", name="map")
    prog = tp.build()
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c.program.source, seed=5)
    assert _units_against_plain(c, dict(env)) == {"elementwise"}
    x, b, sc = env["X"].float(), env["b"], env["s"]
    want = (torch.nn.functional.silu(x + b) * sc).to(torch.bfloat16)
    _assert_kernel_close(c(env)["O"], want, "silu(X + b) * s")


def _map_unit(tin, tout, shape=(64, 96)):
    """A compiled one-unit map, X + b broadcast along rows then gated by Y,
    and its one elementwise launch."""
    m, n = shape
    tp = TileProgram(f"map_{tin}_{tout}")
    tp.input("X", (m, n), tin); tp.input("b", (n,), tin); tp.input("Y", (m, n), tin)
    tp.output("O", (m, n), tout)
    act = "relu" if tin.startswith("int") else "silu"
    tp.op(f"O[i, j] = {act}(X[i, j] + b[j]) * Y[i, j]", name="map")
    prog = tp.build()
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    (_unit, kind, (fn,)), = c._fn.steps
    assert kind == "cuda" and fn.kernel == "elementwise"
    return c, fn


def _launch_path(fn, ins):
    """One launch of ``fn``'s plan on ``ins``; returns (output, path)."""
    before = dict(EW.launches_by_path)
    got = EW.elementwise(fn.plan, ins, fn.out_clip)
    torch.cuda.synchronize()
    ran = [p for p in EW.PATHS if EW.launches_by_path[p] != before[p]]
    assert len(ran) == 1 and EW.launches_by_path[ran[0]] == before[ran[0]] + 1
    return got, ran[0]


@pytest.mark.cuda
@pytest.mark.parametrize("tin,tout", [("float32", "float32"), ("float32", "bfloat16"),
                                      ("bfloat16", "bfloat16"), ("float16", "float16"),
                                      ("int8", "int32")])
def test_elementwise_vec_matches_plain_on_the_card(tin, tout):
    """The vec path against plain, a row-broadcast bias among the inputs:
    integers exactly, float32 within 1e-4, 16-bit floats within 2e-2 of
    the largest output."""
    _card()
    c, fn = _map_unit(tin, tout)
    env = _random_arrays(c.program.source, seed=6)
    ins = [env[s.buf] for s in fn.plan.ins]
    assert EW.vec_view(fn.plan, ins, fn.out_clip) is not None, EW.refusal(fn.plan, ins)
    got, ran = _launch_path(fn, ins)
    assert ran == "vec"
    _assert_kernel_close(got, fn.plain(env), f"{tin} -> {tout}")


@pytest.mark.cuda
def test_elementwise_refused_plans_run_general_on_the_card():
    """A ragged unit (70 points a row) and a misaligned input take the
    general loop, and still match plain."""
    _card()
    tp = TileProgram("ragged")
    tp.input("X", (4, 33, 70), "bfloat16"); tp.input("b", (70,)); tp.input("s", (33, 1))
    tp.output("O", (4, 33, 70), "bfloat16")
    tp.op("O[n, i, j] = silu(X[n, i, j] + b[j]) * s[i, 0]", name="map")
    c = stripe_jit(tp.build(), get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    (_unit, _kind, (fn,)), = c._fn.steps
    env = _random_arrays(c.program.source, seed=7)
    ins = [env[s.buf] for s in fn.plan.ins]
    assert "not a multiple of 8" in EW.refusal(fn.plan, ins, fn.out_clip)
    got, ran = _launch_path(fn, ins)
    assert ran == "general"
    _assert_kernel_close(got, fn.plain(env), "ragged")

    c, fn = _map_unit("float32", "float32")
    env = _random_arrays(c.program.source, seed=8)
    big = torch.randn(64 * 96 + 1, device="cuda")
    env["X"] = big[1:].view(64, 96)  # contiguous, 4 bytes past a 16-byte boundary
    ins = [env[s.buf] for s in fn.plan.ins]
    assert "16-byte" in EW.refusal(fn.plan, ins, fn.out_clip)
    got, ran = _launch_path(fn, ins)
    assert ran == "general"
    _assert_kernel_close(got, fn.plain(env), "misaligned")


@pytest.mark.cuda
def test_elementwise_vec_takes_a_misaligned_row_scale_on_the_card():
    """A per-row scale ``s[i, 0]`` (broadcast along variable 0, its row
    stride 1) read from a slice 4 bytes past a 16-byte boundary: one scalar
    a vector needs no alignment, so the unit takes vec and matches plain."""
    _card()
    tp = TileProgram("row_scale")
    tp.input("X", (13, 48)); tp.input("s", (13, 1))
    tp.output("O", (13, 48))
    tp.op("O[i, j] = relu(X[i, j]) * s[i, 0]", name="map")
    c = stripe_jit(tp.build(), get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    (_unit, _kind, (fn,)), = c._fn.steps
    env = _random_arrays(c.program.source, seed=10)
    env["s"] = torch.randn(14, device="cuda")[1:].view(13, 1)
    ins = [env[s.buf] for s in fn.plan.ins]
    assert EW.vec_view(fn.plan, ins, fn.out_clip) is not None, EW.refusal(fn.plan, ins)
    got, ran = _launch_path(fn, ins)
    assert ran == "vec"
    _assert_kernel_close(got, fn.plain(env), "row scale")


@pytest.mark.cuda
@pytest.mark.parametrize("tin,tout", [("float32", "float32"), ("int8", "int32")])
def test_elementwise_general_path_argument_on_the_card(tin, tout):
    """``path="general"`` forces the general loop on a plan the vec path
    takes; both agree with plain."""
    _card()
    c, fn = _map_unit(tin, tout, shape=(48, 128))
    env = _random_arrays(c.program.source, seed=9)
    ins = [env[s.buf] for s in fn.plan.ins]
    before = dict(EW.launches_by_path)
    vec = EW.elementwise(fn.plan, ins, fn.out_clip)
    gen = EW.elementwise(fn.plan, ins, fn.out_clip, path="general")
    torch.cuda.synchronize()
    assert EW.launches_by_path == {"vec": before["vec"] + 1, "general": before["general"] + 1}
    want = fn.plain(env)
    _assert_kernel_close(vec, want, "vec")
    _assert_kernel_close(gen, want, "general")


@pytest.mark.cuda
def test_elementwise_vec_with_a_clip_on_the_card():
    """A region of 104 points cut to 96 (whole vectors): the vec kernel
    tests each vector against the clip and stores only those inside."""
    _card()
    plan = EW.MapPlan(out_vars=("j",), out_ext=(104,), out_dim=(0,), out_coef=(1,),
                      out_shape=(104,), ins=(K.Slot("X", 0, (1,), ()),),
                      prog=((K.OP_LOAD, 0), (K.OP_UNARY + K.UNARY_OPS.index("relu"), 0)),
                      consts=())
    x = torch.randn(104, device="cuda")
    assert EW.vec_view(plan, [x], (96,)).clipped
    before = dict(EW.launches_by_path)
    got = EW.elementwise(plan, [x], (96,))
    torch.cuda.synchronize()
    assert EW.launches_by_path["vec"] == before["vec"] + 1
    assert torch.equal(got, EW.elementwise_plain(plan, [x], (96,)))


@pytest.mark.cuda
def test_elementwise_vec_kernels_use_no_local_memory_on_the_card():
    """Every vec instantiation keeps its stack in registers: ptxas reports
    0 bytes of stack frame and of spills."""
    _card()
    usage = EW.resource_usage()
    vec = {k: u for k, u in usage.items() if k.startswith("elementwise_vec_kernel")}
    assert set(vec) == {f"elementwise_vec_kernel<{t}, {n}>" for t in ("float", "int")
                        for n in range(1, 7)}
    for name, u in vec.items():
        assert u["stack_frame"] == u["spill_stores"] == u["spill_loads"] == 0, (name, u)
        assert 0 < u["registers"] <= 255, (name, u)
    print({k: (u["registers"], u["stack_frame"]) for k, u in usage.items()})


# ------------------------------------------- flash attention and chunked GLA
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,bq,bk,causal", [
    (2, 4, 4, 128, 128, 64, 64, 64, True),
    (2, 4, 4, 256, 256, 128, 64, 128, False),
    (1, 8, 2, 256, 256, 64, 128, 64, True),     # GQA, 16 rows a warp
    (1, 4, 2, 64, 256, 32, 32, 64, True),       # Sq < Sk: top-left mask
    (1, 4, 1, 256, 64, 96, 64, 32, True),       # Sq > Sk, head dim padded to 128
    (1, 2, 2, 96, 96, 256, 48, 32, False),      # head dim 256: 8 rows a warp at most
    (1, 2, 2, 200, 200, 64, 100, 40, True),     # a warp with 4 of its 16 rows; 40-key blocks
])
def test_flash_attention_kernel_matches_plain_on_the_card(b, hq, hkv, sq, sk, d, bq, bk,
                                                           causal, dtype):
    """The call's path against plain at the case's blocks; where that is
    wgmma or tf32x3 (bf16 or float32 at head dim 64 or 128, whatever the
    blocks), also held to its elementwise bound, and the CUDA-core kernel
    at the same blocks."""
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dt)
    before = FA.launches
    by_path = dict(FA.launches_by_path)
    got = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    path = FA.path_of(q.dtype, d)
    assert FA.launches_by_path[path] == by_path[path] + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    _assert_kernel_close(got, want, "flash_attention")
    if path in ("wgmma", "tf32x3"):
        if path == "wgmma":
            _assert_within_wgmma_bound(FA, got, want, q, k, v, causal)
        else:
            assert _tf32x3_excess(FA, got, want, q, k, v, causal) <= 1.0
        cores = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk,
                                   path="cuda_cores")
        _assert_kernel_close(cores, want, "flash_attention (cuda_cores)")


def _wgmma_excess(FA, got, want, q, k, v, causal):
    """The largest error of the wgmma kernel over ``kernel.wgmma_bound``."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    return (err / FA.wgmma_bound(q, k, v, want, causal)).max().item()


def _assert_within_wgmma_bound(FA, got, want, q, k, v, causal):
    """Element by element: one bf16 step of each output plus 2**-8 of the
    attention of |v|, the most that rounding P to bf16 moves it."""
    excess = _wgmma_excess(FA, got, want, q, k, v, causal)
    assert excess <= 1.0, excess


# the cases of the CPU emulation (tests/test_torch_attention_kernels.py):
# (B, Hq, Hkv, Sq, Sk, D, causal)
WGMMA_CASES = [
    (1, 4, 4, 256, 256, 128, True), (1, 4, 4, 256, 256, 128, False),
    (1, 8, 2, 128, 384, 64, True),    # Sq < Sk: top-left; GQA group 4
    (2, 4, 1, 192, 192, 64, True),    # S not a multiple of the 128-row CTA; group 4
    (1, 2, 2, 320, 320, 64, False),   # S not a multiple of the 64-key tile
    (1, 4, 4, 448, 208, 128, True),   # Sq > Sk; Sk not a multiple of 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", WGMMA_CASES)
def test_flash_attention_wgmma_matches_plain_on_the_card(b, hq, hkv, sq, sk, d, causal):
    """bf16 at head dims 64 and 128 takes the wgmma kernel and agrees with
    the plain version (float32 P) within the bf16 tolerance; a relaunch is
    bit-identical, and the CUDA-core kernel agrees on the same inputs."""
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + d + hq)
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").bfloat16()
    bq, bk = 64, 16
    before = dict(FA.launches_by_path)
    got = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    again = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    cores = FA.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk,
                               path="cuda_cores")
    torch.cuda.synchronize()
    assert FA.launches_by_path == {"wgmma": before["wgmma"] + 2, "tf32x3": before["tf32x3"],
                                   "cuda_cores": before["cuda_cores"] + 1}
    assert torch.equal(got, again)
    want = FA.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    _assert_kernel_close(got, want, "flash_attention (wgmma)")
    _assert_within_wgmma_bound(FA, got, want, q, k, v, causal)
    _assert_kernel_close(cores, want, "flash_attention (cuda_cores)")


# faults planted in a copy of the wgmma kernel: (what, the fault site that
# marks the line, the text in it, its fault)
WGMMA_FAULTS = [
    ("O not rescaled by alpha", "flash wgmma rescale", "o[i] *= alpha[(i >> 1) & 1];",
     "o[i] *= 1.0f;"),
    ("the diagonal key masked", "flash wgmma causal mask", "r0 + 8 * r < key",
     "r0 + 8 * r <= key"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("what,site,text,fault", WGMMA_FAULTS, ids=[f[0] for f in WGMMA_FAULTS])
def test_the_wgmma_bound_catches_a_planted_fault(what, site, text, fault, tmp_path, monkeypatch,
                                                 capsys):
    """A copy of the sources with one fault in the wgmma kernel builds,
    runs wgmma, and fails the elementwise bound at llama3-8b's head
    layout (Hq 32, Hkv 8, D 128, S 1024, causal).  Prints both checks'
    verdicts: the bound's largest error over bound, and whether the
    tolerance of 2e-2 of the largest output would have passed it."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = (tmp_path / "flash_attention.cu").read_text()
    (line,) = _fault_sites(src, site)
    assert text in line, line
    (tmp_path / "flash_attention.cu").write_text(src.replace(line, line.replace(text, fault)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(1, 32, 1024, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 8, 1024, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 8, 1024, 128, generator=gen, device="cuda").bfloat16()
    want = FA.flash_attention_plain(q, k, v, causal=True)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    before = FA.launches_by_path["wgmma"]
    got = FA.flash_attention(q, k, v, causal=True)
    assert FA.launches_by_path["wgmma"] == before + 1
    excess = _wgmma_excess(FA, got, want, q, k, v, True)
    err = (got.float() - want.float()).abs().max().item()
    loose = err <= 2e-2 * (1 + want.float().abs().max().item())
    with capsys.disabled():
        print(f"\nplanted fault '{what}': error / bound {excess:.3f}, largest error "
              f"{err:.3e}, passes 2e-2 of the largest output: {loose}")
    assert excess > 1.0, (what, excess)


def _tf32x3_excess(FA, got, want, q, k, v, causal):
    """The largest error of the tf32x3 kernel over ``kernel.flash_tf32x3_bound``."""
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    return (err / FA.flash_tf32x3_bound(q, k, v, want, causal)).max().item()


# llama3-8b's head layout (Hq 32, Hkv 8, D 128) unless named, and blocks
# that divide the sequence (the reference's rule; the kernel runs its own
# tiles): (B, Hq, Hkv, Sq, Sk, D, causal, block_q, block_k)
TF32X3_CASES = [
    (1, 32, 8, 1024, 1024, 128, True, None, None),
    (1, 32, 8, 1024, 1024, 128, False, None, None),
    (1, 32, 8, 512, 2048, 128, True, None, None),   # Sq < Sk: top-left
    (1, 32, 8, 200, 200, 128, True, 40, 40),        # Sq not a multiple of the 128-row CTA
    (1, 32, 8, 300, 1003, 128, False, 100, 59),     # Sk not a multiple of 8 nor of 32 keys
    (2, 8, 2, 448, 208, 64, True, 64, 16),          # head dim 64; Sq > Sk
    (2048, 32, 8, 40, 40, 128, True, None, None),   # B*Hq = 65536
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,bq,bk", TF32X3_CASES)
def test_flash_attention_tf32x3_matches_plain_on_the_card(b, hq, hkv, sq, sk, d, causal, bq,
                                                          bk, capsys):
    """float32 at head dims 64 and 128 takes the tf32x3 kernel and agrees
    with the plain version within 1e-4 of the largest output and element
    by element within ``kernel.flash_tf32x3_bound``; a relaunch is
    bit-identical, and ``path="cuda_cores"`` launches the CUDA-core kernel,
    which agrees with plain on the same inputs."""
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + d + hq)
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda")
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
    assert FA.path_of(q.dtype, d) == "tf32x3"
    before = dict(FA.launches_by_path)
    blocks = {"block_q": bq, "block_k": bk}
    got = FA.flash_attention(q, k, v, causal=causal, **blocks)
    again = FA.flash_attention(q, k, v, causal=causal, **blocks)
    cores = FA.flash_attention(q, k, v, causal=causal, path="cuda_cores", **blocks)
    torch.cuda.synchronize()
    assert FA.launches_by_path == {"wgmma": before["wgmma"], "tf32x3": before["tf32x3"] + 2,
                                   "cuda_cores": before["cuda_cores"] + 1}
    assert torch.equal(got, again)
    want = FA.flash_attention_plain(q, k, v, causal=causal, **blocks)
    _assert_kernel_close(got, want, "flash_attention (tf32x3)")
    excess = _tf32x3_excess(FA, got, want, q, k, v, causal)
    with capsys.disabled():
        print(f"\ntf32x3 B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} causal={causal}: "
              f"error / bound {excess:.3f}")
    assert excess <= 1.0, excess
    _assert_kernel_close(cores, want, "flash_attention (cuda_cores)")


@pytest.mark.cuda
def test_the_flash_tf32x3_bound_catches_a_planted_fault(tmp_path, monkeypatch, capsys):
    """A copy of the sources whose tf32x3 kernel keeps only a_hi b_hi in
    both products (plain TF32: the lo products removed) builds, runs
    tf32x3, and fails the elementwise bound at llama3-8b's head layout
    (Hq 32, Hkv 8, D 128, S 1024, causal).  Prints its error over the
    bound and whether the 1e-4 gate of the largest output would have
    passed it."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = (tmp_path / "flash_attention.cu").read_text()
    lo_terms = _fault_sites(src, "flash tf32x3 lo product")
    assert len(lo_terms) == 4 and all("mma" in line for line in lo_terms), lo_terms
    for line in lo_terms:
        src = src.replace(line + "\n", "")
    (tmp_path / "flash_attention.cu").write_text(src)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(1, 32, 1024, 128, generator=gen, device="cuda")
    k = torch.randn(1, 8, 1024, 128, generator=gen, device="cuda")
    v = torch.randn(1, 8, 1024, 128, generator=gen, device="cuda")
    want = FA.flash_attention_plain(q, k, v, causal=True)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    before = FA.launches_by_path["tf32x3"]
    got = FA.flash_attention(q, k, v, causal=True)
    assert FA.launches_by_path["tf32x3"] == before + 1
    excess = _tf32x3_excess(FA, got, want, q, k, v, True)
    err = (got - want).abs().max().item()
    loose = err <= 1e-4 * (1 + want.abs().max().item())
    with capsys.disabled():
        print(f"\nplanted fault 'flash lo products removed': error / bound {excess:.3f}, "
              f"largest error {err:.3e}, passes 1e-4 of the largest output: {loose}")
    assert excess > 1.0, excess


def _gla_case(b, h, s, dk, dv, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = (0.5 * torch.randn(b, h, s, dk, generator=gen, device="cuda")).to(dt)
    k = (0.5 * torch.randn(b, h, s, dk, generator=gen, device="cuda")).to(dt)
    v = (0.5 * torch.randn(b, h, s, dv, generator=gen, device="cuda")).to(dt)
    ld = -0.2 * torch.randn(b, h, s, generator=gen, device="cuda").abs()
    g = 0.5 * torch.randn(b, h, s, generator=gen, device="cuda").abs()
    return q, k, v, ld, g


def _gla_wgmma_excess(GLA, got, want, ins, chunk, normalize, scale):
    """The largest error of the GLA wgmma path over ``kernel.gla_wgmma_bound``."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    return (err / GLA.gla_wgmma_bound(*ins, want, chunk, normalize, scale)).max().item()


def _gla_tf32x3_excess(GLA, got, want, ins, chunk, normalize, scale):
    """The largest error of the GLA tf32x3 path over ``kernel.gla_tf32x3_bound``."""
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    return (err / GLA.gla_tf32x3_bound(*ins, want, chunk, normalize, scale)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("b,h,s,dk,dv,chunk,dtype,path", [
    (1, 2, 64, 16, 24, 16, "float32", "cuda_cores"),
    (2, 2, 128, 32, 32, 32, "float32", "cuda_cores"),
    (1, 3, 256, 40, 96, 128, "float32", "tf32x3"),  # ragged: zeros past Dk and Dv in the boxes
    (1, 2, 512, 384, 384, 256, "float32", "tf32x3"),  # xlstm-125m's head width
    (2, 2, 512, 64, 64, 256, "float32", "tf32x3"),    # the SSD's (P = N = 64)
    (2, 70, 256, 128, 64, 64, "float32", "tf32x3"),   # Dk != Dv; B*H = 140 over 132 SMs
    (2, 2, 512, 64, 64, 256, "bfloat16", "wgmma"),  # two row tiles under the diagonal
    (1, 2, 512, 384, 384, 256, "bfloat16", "wgmma"),  # xlstm-125m's head width
    (2, 70, 256, 128, 64, 64, "bfloat16", "wgmma"),   # Dk != Dv; B*H = 140 over 132 SMs
    (1, 3, 256, 48, 80, 128, "bfloat16", "wgmma"),    # ragged: zeros past Dk and Dv in the boxes
])
def test_gla_kernel_matches_plain_on_the_card(b, h, s, dk, dv, chunk, dtype, path, normalize,
                                              capsys):
    """The call's path (``path_of``) against plain within the type's
    tolerance; a wgmma call also element by element within
    ``kernel.gla_wgmma_bound``, a tf32x3 call within
    ``kernel.gla_tf32x3_bound``, and either one's CUDA-core kernel on the
    same inputs against plain."""
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.nn.scan_ops import chunked_gla_torch

    _card()
    ins = _gla_case(b, h, s, dk, dv, dtype, s + dk + dv)
    before, by_path = GLA.launches, dict(GLA.launches_by_path)
    got = GLA.chunked_gla(*ins, chunk=chunk, normalize=normalize, scale=0.5)
    torch.cuda.synchronize()
    assert GLA.path_of(ins[0].dtype, dk, dv, chunk) == path
    assert GLA.launches == before + 1
    assert GLA.launches_by_path[path] == by_path[path] + 1
    want = chunked_gla_torch(*ins, chunk=chunk, normalize=normalize, scale=0.5)
    _assert_kernel_close(got, want, f"chunked_gla ({path})")
    if path == "cuda_cores":
        return
    check = _gla_wgmma_excess if path == "wgmma" else _gla_tf32x3_excess
    excess = check(GLA, got, want, ins, chunk, normalize, 0.5)
    with capsys.disabled():
        print(f"\n{path} B{b} H{h} S{s} Dk{dk} Dv{dv} chunk {chunk} normalize={normalize}: "
              f"error / bound {excess:.3f}")
    assert excess <= 1.0, excess
    cores = GLA.chunked_gla(*ins, chunk=chunk, normalize=normalize, scale=0.5, path="cuda_cores")
    _assert_kernel_close(cores, want, "chunked_gla (cuda_cores)")


def _fault_sites(src, name):
    """The lines of a kernel source marked ``// fault site: <name>``, where
    the planted-fault tests change it."""
    return [line for line in src.splitlines() if line.endswith(f"// fault site: {name}")]


@pytest.mark.cuda
def test_the_gla_wgmma_bound_catches_a_planted_fault(tmp_path, monkeypatch, capsys):
    """A copy of the sources whose state kernel drops the carry's
    exp(total) (C is never decayed from one chunk to the next) builds,
    runs wgmma, and fails the elementwise bound on an mLSTM (B 1, H 4, S
    1024, Dk = Dv = 128, chunk 256, forget-gate bias 3, normalized).
    Prints its error over the bound and whether the 2e-2 gate of the
    largest output would have passed it."""
    import shutil

    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.nn.scan_ops import chunked_gla_torch

    _card()
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = (tmp_path / "gla.cu").read_text()
    (line,) = _fault_sites(src, "bf16 carry decay")
    assert "*= et;" in line, line
    (tmp_path / "gla.cu").write_text(src.replace(line, line.replace("*= et", "*= 1.0f")))
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 4, 1024, 128, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    f_gate = 3.0 + torch.randn(1, 4, 1024, generator=gen, device="cuda")
    i_gate = torch.randn(1, 4, 1024, generator=gen, device="cuda")
    ins = (q, k, v, F.logsigmoid(f_gate), torch.exp(i_gate))
    want = chunked_gla_torch(*ins, chunk=256, normalize=True, scale=128 ** -0.5)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    before = GLA.launches_by_path["wgmma"]
    got = GLA.chunked_gla(*ins, chunk=256, normalize=True, scale=128 ** -0.5)
    assert GLA.launches_by_path["wgmma"] == before + 1
    excess = _gla_wgmma_excess(GLA, got, want, ins, 256, True, 128 ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    loose = err <= 2e-2 * (1 + want.float().abs().max().item())
    with capsys.disabled():
        print(f"\nplanted fault 'carry not decayed': error / bound {excess:.3f}, largest "
              f"error {err:.3e}, passes 2e-2 of the largest output: {loose}")
    assert excess > 1.0, excess


@pytest.mark.cuda
def test_the_gla_tf32x3_bound_catches_a_planted_fault(tmp_path, monkeypatch, capsys):
    """A copy of the sources whose 3xTF32 product keeps only a_hi b_hi
    (plain TF32: the lo products removed) builds, runs tf32x3, and fails
    the elementwise bound on an mLSTM (B 1, H 4, S 1024, Dk = Dv = 384,
    chunk 256, forget-gate bias 3, normalized, float32).  A second copy
    that also leaves the low mantissa bits in place (hi = x: the tensor
    cores' own reading of a float32 as tf32) fails it too; whether its
    output equals the first's bit for bit says whether the card truncates
    those bits (equal) or rounds them.  Prints each error over the bound."""
    import shutil

    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.nn.scan_ops import chunked_gla_torch

    _card()
    mask = "#define TF32_MASK 0xffffe000u"
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 4, 1024, 384, generator=gen, device="cuda") for _ in range(3))
    f_gate = 3.0 + torch.randn(1, 4, 1024, generator=gen, device="cuda")
    i_gate = torch.randn(1, 4, 1024, generator=gen, device="cuda")
    ins = (q, k, v, F.logsigmoid(f_gate), torch.exp(i_gate))
    kw = {"chunk": 256, "normalize": True, "scale": 384 ** -0.5}
    want = chunked_gla_torch(*ins, **kw)
    outs, csrc = {}, _build.CSRC
    for what, keep_bits in (("lo products removed", False),
                            ("lo products removed, low bits left", True)):
        src_dir = tmp_path / what.replace(" ", "_").replace(",", "")
        src_dir.mkdir()
        for f in csrc.iterdir():
            shutil.copy(f, src_dir / f.name)
        gla = (src_dir / "gla.cu").read_text()
        lo_terms = _fault_sites(gla, "tf32x3 lo product")
        assert len(lo_terms) == 2 and all("mma_rs" in line for line in lo_terms), lo_terms
        for line in lo_terms:
            gla = gla.replace(line + "\n", "")
        (src_dir / "gla.cu").write_text(gla)
        if keep_bits:
            hdr = (src_dir / "hopper.cuh").read_text()
            assert hdr.count(mask) == 1, mask
            (src_dir / "hopper.cuh").write_text(hdr.replace(mask, "#define TF32_MASK 0xffffffffu"))
        monkeypatch.setattr(_build, "CSRC", src_dir)
        monkeypatch.setattr(_build, "_LIBS", {})
        before = GLA.launches_by_path["tf32x3"]
        outs[what] = got = GLA.chunked_gla(*ins, **kw)
        assert GLA.launches_by_path["tf32x3"] == before + 1
        excess = _gla_tf32x3_excess(GLA, got, want, ins, kw["chunk"], True, kw["scale"])
        err = (got - want).abs().max().item()
        with capsys.disabled():
            print(f"\nplanted fault '{what}': error / bound {excess:.3f}, largest error "
                  f"{err:.3e} (largest output {want.abs().max().item():.3e})")
        assert excess > 1.0, (what, excess)
    same = torch.equal(*outs.values())
    with capsys.disabled():
        print(f"the tensor cores {'truncate' if same else 'round'} the low 13 mantissa bits of "
              f"a float32 read as tf32 (outputs bit for bit equal: {same})")


@pytest.mark.cuda
def test_b_times_h_over_65535_on_the_card():
    """b*h rides on grid x, so B*H = 65536 runs: the GLA kernel on every
    path (bf16 on wgmma and on the CUDA cores, float32 on tf32x3 and on the
    CUDA cores) and flash attention's CUDA-core kernel (float32), each
    against its plain version."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.nn.scan_ops import chunked_gla_torch

    _card()
    for dtype, path in (("bfloat16", None), ("bfloat16", "cuda_cores"), ("float32", None),
                        ("float32", "cuda_cores")):
        ins = _gla_case(1024, 64, 64, 16, 16, dtype, 11)
        by_path = dict(GLA.launches_by_path)
        got = GLA.chunked_gla(*ins, chunk=64, normalize=True, scale=0.5, path=path)
        ran = path or GLA.path_of(ins[0].dtype, 16, 16, 64)
        assert GLA.launches_by_path[ran] == by_path[ran] + 1
        want = chunked_gla_torch(*ins, chunk=64, normalize=True, scale=0.5)
        _assert_kernel_close(got, want, f"chunked_gla B*H 65536 ({dtype}, {ran})")
        if ran == "wgmma":
            assert _gla_wgmma_excess(GLA, got, want, ins, 64, True, 0.5) <= 1.0
        if ran == "tf32x3":
            assert _gla_tf32x3_excess(GLA, got, want, ins, 64, True, 0.5) <= 1.0
        del ins, got, want
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(1024, 64, 32, 32, generator=gen, device="cuda") for _ in range(3))
    before = FA.launches_by_path["cuda_cores"]
    got = FA.flash_attention(q, k, v, causal=True, block_q=32, block_k=32)
    assert FA.launches_by_path["cuda_cores"] == before + 1
    _assert_kernel_close(got, FA.flash_attention_plain(q, k, v, causal=True, block_q=32,
                                                       block_k=32), "flash B*Hq 65536")


@pytest.mark.cuda
def test_mlstm_and_ssd_wrappers_launch_the_gla_kernel():
    from repro_torch.kernels.mlstm_chunk import kernel as GLA
    from repro_torch.kernels.mlstm_chunk import mlstm_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_ref

    _card()
    gen = torch.Generator(device="cuda").manual_seed(21)
    B, H, S = 2, 2, 128

    def rnd(*shape):
        return 0.5 * torch.randn(*shape, generator=gen, device="cuda")

    before = GLA.launches
    q, k, v = rnd(B, H, S, 32), rnd(B, H, S, 32), rnd(B, H, S, 32)
    ig, fg = rnd(B, H, S), rnd(B, H, S) + 2.0
    got = GLA.mlstm_chunk(q, k, v, ig, fg, chunk=32)
    _assert_kernel_close(got, mlstm_ref(q, k, v, ig, fg), "mlstm_chunk vs recurrence")
    x, dt = rnd(B, H, S, 16), rnd(B, H, S).abs() * 0.6
    A, Bm, Cm, D = -rnd(H).abs() * 2, rnd(B, H, S, 8), rnd(B, H, S, 8), rnd(H)
    _assert_kernel_close(ssd_chunk(x, dt, A, Bm, Cm, D, chunk=32),
                         ssd_ref(x, dt, A, Bm, Cm, D), "ssd_chunk vs recurrence")
    torch.cuda.synchronize()
    assert GLA.launches == before + 2


@pytest.mark.cuda
def test_a_broken_kernel_source_raises_kernel_build_error(tmp_path, monkeypatch):
    """A source that does not compile surfaces as KernelBuildError from the
    launch; nothing falls back to the plain version."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FA

    _card()
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    (tmp_path / "flash_attention.cu").write_text(
        (tmp_path / "flash_attention.cu").read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    q = torch.zeros(1, 1, 64, 32, device="cuda")
    before = FA.launches
    with pytest.raises(_build.KernelBuildError, match="flash_attention.cu"):
        FA.flash_attention(q, q, q, block_q=64, block_k=64)
    assert FA.launches == before


# ------------------------------------------ the contraction kernel's paths
def _gemm_program(m, n, k, dtype, out=None, epilogue=False, transposed=False):
    """O[i, j] = A[i, c] * B[c, j] at (m, n, k) in ``dtype`` (``out``:
    the output type); ``epilogue``: a scale, a bias and a residual input;
    ``transposed``: A stored [c, i] and B [j, c]."""
    out = out or ("int32" if dtype == "int8" else dtype)
    tp = TileProgram(f"mm_{m}x{n}x{k}_{dtype}")
    a_ref, b_ref = ("A[c, i]", "B[j, c]") if transposed else ("A[i, c]", "B[c, j]")
    tp.input("A", (k, m) if transposed else (m, k), dtype)
    tp.input("B", (n, k) if transposed else (k, n), dtype)
    if epilogue:
        tp.input("b", (n,)); tp.input("R", (m, n))
        tp.temp("T", (m, n)); tp.output("O", (m, n), out)
        tp.op(f"T[i, j] += 0.5 * {a_ref} * {b_ref}", name="mm")
        tp.op("O[i, j] = gelu(T[i, j] + b[j]) + R[i, j]", name="epi")
    else:
        tp.output("O", (m, n), out)
        tp.op(f"O[i, j] += {a_ref} * {b_ref}", name="mm")
    return tp.build()


def _gqa_program(name, b, kv, g, t, d, dtype="float32"):
    tp = TileProgram(name)
    if name == "scores":
        tp.input("Q", (b, kv, g, d), dtype); tp.input("K", (b, t, kv, d), dtype)
        tp.output("S", (b, kv, g, t), dtype)
        tp.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    else:
        tp.input("P", (b, kv, g, t), dtype); tp.input("V", (b, t, kv, d), dtype)
        tp.output("O", (b, kv, g, d), dtype)
        tp.op("O[b, k, g, d] += P[b, k, g, t] * V[b, t, k, d]", name="values")
    return tp.build()


def _operands(fn, env):
    plan = fn.plan
    return [env[s.buf] for s in plan.slots], [env[s.buf] for s in plan.eslots]


def _paths_against_plain(prog, expect):
    """Every contraction unit of ``prog`` under h100: the view's path (must
    be ``expect``) twice, bit-identical, and the general loop, each against
    the plain version; ``launches_by_path`` counts each launch once."""
    c = stripe_jit(prog, get_config("h100"), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    assert c.record.backend == "cuda", c.record.fallback_reasons()
    env = _random_arrays(c.program.source, seed=5)
    views = []
    for unit, kind, fns in c._fn.steps:
        assert kind == "cuda", unit.name
        for fn in fns:
            if fn.kernel != "contraction":
                env[fn.out_buf] = LC._place(env, prog.buffers[fn.out_buf], fn, fn(env))
                continue
            path = K.plan_path(fn.plan)
            assert path == expect, (unit.name, K.refusal(fn.plan))
            before = dict(K.launches_by_path)
            got, again, want = fn(env), fn(env), fn.plain(env)
            clip = getattr(fn, "out_clip", fn.out_shape)
            general = K.contraction(fn.plan, *_operands(fn, env), clip, path="general")
            torch.cuda.synchronize()
            after = dict(before)
            after[path] += 2
            after["general"] += 1
            assert K.launches_by_path == after
            assert torch.equal(got, again), f"{unit.name}: two launches differ"
            _assert_kernel_close(got, want, f"{unit.name} ({path})")
            _assert_kernel_close(general, want, f"{unit.name} (general)")
            env[fn.out_buf] = LC._place(env, prog.buffers[fn.out_buf], fn, got)
            views.append(K.gemm_view(fn.plan))
    assert views
    return views


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 128])
def test_contraction_paths_match_plain_on_the_card(m, dtype):
    """N and K that are not multiples of any tile; m <= 16 skinny, else
    tiled (wgmma for bf16/f16/int8, the CUDA cores for float32); int8
    bit-exact."""
    _card()
    views = _paths_against_plain(_gemm_program(m, 200, 300, dtype),
                                 "skinny" if m <= 16 else "tiled")
    if m > 16:
        assert views[0].mma == ("ffma" if dtype == "float32" else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 192])
def test_contraction_paths_scale_and_epilogue_on_the_card(m, dtype):
    """The scale and an epilogue with extra inputs (bias, residual) at the
    element's output coordinates, on each path."""
    _card()
    _paths_against_plain(_gemm_program(m, 136, 200, dtype, epilogue=True),
                         "skinny" if m <= 16 else "tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m", [4, 130])
def test_contraction_paths_transposed_operands_on_the_card(m, dtype):
    """A stored [k, m] and B [n, k]: unit strides along M and K, so the
    16-bit and int8 tiles of A go through the pack pass and B's through TMA
    in place; the skinny path reads B along K."""
    _card()
    views = _paths_against_plain(_gemm_program(m, 136, 256, dtype, transposed=True),
                                 "skinny" if m <= 16 else "tiled")
    if m > 16 and dtype != "float32":
        assert (views[0].a.load, views[0].b.load) == ("pack+tma", "tma")
    if m <= 16:
        assert views[0].kv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [4, 24])
@pytest.mark.parametrize("name", ["scores", "values"])
def test_contraction_paths_gqa_batch_dims_on_the_card(name, g, dtype):
    """The GQA scores/values programs: b and k are batch dims of every
    path (g = 4 rows: skinny; g = 24: tiled)."""
    _card()
    views = _paths_against_plain(_gqa_program(name, 2, 4, g, 72, 40, dtype),
                                 "skinny" if g <= 16 else "tiled")
    assert views[0].batch_ext == (2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
def test_bf16_output_is_rounded_once_on_the_card(m):
    """A bf16 output is the float32 sum rounded once: the same product with
    a float32 output, rounded to bf16, equals it bit for bit (same path,
    same summation order)."""
    _card()
    c16 = stripe_jit(_gemm_program(m, 200, 300, "bfloat16"), get_config("h100"), "cuda",
                     cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    c32 = stripe_jit(_gemm_program(m, 200, 300, "bfloat16", out="float32"),
                     get_config("h100"), "cuda",
                     cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    env = _random_arrays(c16.program.source, seed=6)
    got16, got32 = c16(env)["O"], c32(env)["O"]
    assert got16.dtype == torch.bfloat16 and got32.dtype == torch.float32
    assert torch.equal(got16, got32.to(torch.bfloat16))


# ------------------------------------------------------------ tuning DB
@pytest.mark.cuda
def test_tuned_replay_on_the_card_logs_interpret_false(tmp_path):
    """The first profiled call on the card (which builds the plans' launch
    parameters) logs nothing; the second writes residual rows and a DB
    entry with ``interpret`` false (the kernels ran, not their plain
    versions); a compile for the card then replays it, and nothing of the
    plain versions' slot."""
    from repro_torch.obs import profile as obs_profile
    from repro_torch.tune import TuningDB

    _card()
    hw = get_config("h100")
    prog = _gemm_program(128, 256, 192, "float32")
    cache = t_cache.CompilationCache(disk_dir=tmp_path)
    db = TuningDB(dir=tmp_path)
    c1 = stripe_jit(prog, hw, "cuda", cache=cache, profile=True, tune=db)
    assert c1.record.decision_source == "analytic"
    env = _random_arrays(c1.program.source, seed=3)
    before = K.launches
    want = c1(env)["O"]
    torch.cuda.synchronize()
    assert K.launches > before
    log = obs_profile.residual_log_path(cache)
    assert not obs_profile.read_residuals(log) and not c1.record.measured_latency_s
    rec = c1.record
    assert db.lookup(rec.ir_fingerprint, rec.hw_fingerprint, "cuda", False) is None
    assert torch.equal(c1(env)["O"], want)
    rows = obs_profile.read_residuals(log)
    assert rows and all(r["interpret"] is False for r in rows)
    assert db.lookup(rec.ir_fingerprint, rec.hw_fingerprint, "cuda", True) is None
    entry = db.lookup(rec.ir_fingerprint, rec.hw_fingerprint, "cuda", False)
    assert entry is not None and entry.source == "profile"
    c2 = stripe_jit(prog, hw, "cuda", cache=t_cache.CompilationCache(disk_dir=tmp_path),
                    tune=db)
    assert c2.record.decision_source == "tuned"
    assert c2.record.tuned["candidate_id"] == entry.candidate_id
    assert set(c2.record.block_backends.values()) == {"cuda"}
    assert torch.equal(c2(env)["O"], want)


# --------------------------------------------------------------- oplib
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 512])
def test_oplib_linear_on_the_card(m, dtype):
    """``oplib.linear`` under ``cuda`` at llama3-8b's gate projection
    (4096 -> 14336, silu epilogue): one launch of the contraction kernel,
    skinny at m = 4 and tiled at m = 512 (wgmma in bf16), every unit on the
    kernel, against its plain version on the same tensors."""
    from repro_torch.core import oplib

    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    tdt = getattr(torch, dtype)
    x = torch.randn(m, 4096, generator=gen, device="cuda").to(tdt)
    w = (torch.randn(4096, 14336, generator=gen, device="cuda") * 4096 ** -0.5).to(tdt)
    old = oplib.get_backend()
    oplib.set_backend("cuda")
    try:
        before = dict(K.launches_by_path)
        got = oplib.linear(x, w, act="silu")
        torch.cuda.synchronize()
        ran = {p: K.launches_by_path[p] - before[p] for p in before}
    finally:
        oplib.set_backend(old)
    expect = "skinny" if m <= 16 else "tiled"
    assert ran == {**{p: 0 for p in ran}, expect: 1}, ran
    op = oplib._compiled_linear(m, 4096, 14336, dtype, "float32", "silu", False, "cuda")
    assert set(op.block_backends.values()) == {"cuda"}, op.block_reasons
    ((_unit, kind, (fn,)),) = op.cuda_fn.steps
    if m > 16:
        assert K.gemm_view(fn.plan).mma == ("ffma" if dtype == "float32" else "wgmma")
    want = fn.plain({"X": x, "W": w})
    assert got.dtype == tdt
    _assert_kernel_close(got, want, f"linear m={m} {dtype} ({expect})")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(400, 2048, 4096), (400, 4096, 2048), (1424, 6144, 1024)])
def test_oplib_ragged_rows_on_the_card(m, k, n):
    """The wave's prefill rows (4 x 100, and the VLM's 4 x 356) at
    qwen3-moe-30b-a3b's q and o projections and internvl2-26b's k / v,
    bf16: the interior piece and the ragged edge the boundary pass splits
    off run as one launch, tiled on wgmma, against its plain version."""
    from repro_torch.core import oplib

    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    old = oplib.get_backend()
    oplib.set_backend("cuda")
    try:
        before = dict(K.launches_by_path)
        got = oplib.linear(x, w)
        torch.cuda.synchronize()
        ran = {p: K.launches_by_path[p] - before[p] for p in before}
    finally:
        oplib.set_backend(old)
    assert ran == {**{p: 0 for p in ran}, "tiled": 1}, ran
    op = oplib._compiled_linear(m, k, n, "bfloat16", "float32", None, False, "cuda")
    ((_unit, kind, (fn,)),) = op.cuda_fn.steps
    assert kind == "cuda" and fn.out_shape == (m, n) and K.gemm_view(fn.plan).mma == "wgmma"
    _assert_kernel_close(got, fn.plain({"X": x, "W": w}), f"ragged linear {m}x{k}x{n}")


def _moe_cfg(**kw):
    from repro_torch import configs

    cfg = configs.get("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, **kw)


@pytest.mark.cuda
def test_moe_apply_on_the_card_matches_the_cpu():
    """``moe_apply`` at qwen3-moe-30b-a3b's width (d 2048, 128 experts
    top-8, d_ff_expert 768) in float32 on 4 x 100 tokens: on the card the
    scatter-adds are atomic (the combine adds 8 contributions a token in
    no fixed order), on the CPU sequential; the outputs agree within 1e-5
    of the largest and the aux loss within 1e-5."""
    from repro_torch.nn.moe import moe_apply, moe_init

    _card()
    cfg = _moe_cfg(dtype="float32")
    p = moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 100, cfg.d_model).astype(np.float32))
    want, want_aux = moe_apply(p, x, cfg)
    got, got_aux = moe_apply({k: v.cuda() for k, v in p.items()}, x.cuda(), cfg)
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1.0), err
    assert abs(got_aux.item() - want_aux.item()) <= 1e-5


def _wave_calls(cfg, new_tokens: int = 4):
    """The serve prompts (17, 40, 64, 100) through ``WaveEngine(model, 4,
    128)`` on the card, seeded bf16 weights drawn there, ``oplib`` on
    ``cuda`` and on ``torch``: per backend, each call's launches by path
    and the logits behind its greedy tokens."""
    from repro_torch import api
    from repro_torch.core import oplib

    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=p) for p in (17, 40, 64, 100)]
    runs = {}
    old = oplib.get_backend()
    try:
        for backend in ("cuda", "torch"):
            oplib.set_backend(backend)
            calls = []

            def counted(fn, calls=calls):
                def call(*a):
                    before = dict(K.launches_by_path)
                    logits, cache = fn(*a)
                    torch.cuda.synchronize()
                    calls.append(({p: K.launches_by_path[p] - before[p] for p in before},
                                  logits[:, -1, : cfg.vocab].float().cpu()))
                    return logits, cache
                return call

            wrapped = dataclasses.replace(model, prefill=counted(model.prefill),
                                          decode_step=counted(model.decode_step))
            engine = api.WaveEngine(wrapped, 4, 128)
            for uid, p in enumerate(prompts):
                engine.submit(api.Request(uid=uid, prompt=p,
                                          sampling=api.SamplingParams(max_new_tokens=new_tokens)))
            done = engine.run(params)
            assert sorted(r.uid for r in done) == [0, 1, 2, 3]
            assert all(len(r.out_tokens) == new_tokens for r in done)
            runs[backend] = calls
    finally:
        oplib.set_backend(old)
    return runs


def _assert_wave_launches(runs, per_call, new_tokens: int = 4, free_logits: bool = True):
    """Every projection one launch a call: tiled at the prefill, skinny at
    each decode step, never the general loop; nothing on ``torch``; the
    first tokens' logits finite and (``free_logits``) within 5e-2 of the
    row's largest."""
    assert [c for c, _ in runs["cuda"]] == (
        [{"skinny": 0, "tiled": per_call, "general": 0}]
        + [{"skinny": per_call, "tiled": 0, "general": 0}] * (new_tokens - 1))
    assert all(sum(c.values()) == 0 for c, _ in runs["torch"])
    a, b = runs["cuda"][0][1], runs["torch"][0][1]
    assert torch.isfinite(a).all()
    if free_logits:
        assert ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item() <= 5e-2


def _chip_smoke():
    """The repository's ``chip_smoke`` module (its phase helpers)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _hold_hybrid_blocks(cfg):
    """The hybrid's prefill (4 x 100 tokens) and one decode step on
    ``cuda``, keeping every block's input and output, then on ``torch``
    feeding each block the kept input (``chip_smoke.hybrid_blocks``): each
    block's output within 5e-2 of its largest element.  No residual runs
    around a Mamba2 layer, so a free run amplifies a rounding difference
    about 1.5 times a block (chip_smoke phase 12)."""
    hybrid_blocks = _chip_smoke().hybrid_blocks
    from repro_torch import api
    from repro_torch.core import oplib

    model = api.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(1, cfg.vocab, size=(4, 100))).cuda()}
    step = torch.from_numpy(rng.randint(1, cfg.vocab, size=(4, 1))).cuda()
    kept, errs = [], []

    def held(out, want):
        errs.append(((out.float() - want.float()).abs().max() / want.float().abs().max()).item())

    old = oplib.get_backend()
    try:
        for backend, hold in (("cuda", None), ("torch", held)):
            oplib.set_backend(backend)
            with hybrid_blocks(kept, hold):
                _, cache = model.prefill(params, batch, model.init_cache(4, 128))
                model.decode_step(params, cache, step)
    finally:
        oplib.set_backend(old)
    groups = -(-cfg.n_layers // cfg.hybrid.shared_attn_every)
    assert len(errs) == len(kept) == 2 * groups * (1 + cfg.hybrid.shared_attn_every)
    assert max(errs) <= 5e-2, errs


@pytest.mark.cuda
def test_wave_serves_qwen3_moe_on_the_card():
    """A 2-layer qwen3-moe-30b-a3b at full width (bf16, seeded weights
    drawn on the card) through ``WaveEngine`` on the card, ``oplib`` on
    ``cuda`` and on ``torch``: every request finishes; the cuda run
    launches the contraction kernel 4 times a layer a call, tiled at the
    prefill (4 x 100 rows) and skinny at each decode step, never the
    general loop; the torch run launches nothing; the first tokens'
    logits agree within 5e-2 of the row's largest."""
    _card()
    cfg = _moe_cfg(n_layers=2)
    _assert_wave_launches(_wave_calls(cfg), 4 * cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [400, 4])
def test_zamba2_ragged_in_proj_on_the_card(m):
    """zamba2-2.7b's Mamba2 ``in_proj``, 2560 -> 10448 (2 * 5120 + 2 * 64
    + 80: no multiple of a tile), bf16, at the wave's prefill rows (4 x
    100) and decode rows: one launch (tiled on wgmma, or skinny) against
    its plain version."""
    from repro_torch.core import oplib

    _card()
    k, n = 2560, 10448
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    path = "tiled" if m == 400 else "skinny"
    old = oplib.get_backend()
    oplib.set_backend("cuda")
    try:
        before = dict(K.launches_by_path)
        got = oplib.linear(x, w)
        torch.cuda.synchronize()
        ran = {p: K.launches_by_path[p] - before[p] for p in before}
    finally:
        oplib.set_backend(old)
    assert ran == {**{p: 0 for p in ran}, path: 1}, ran
    op = oplib._compiled_linear(m, k, n, "bfloat16", "float32", None, False, "cuda")
    ((_unit, kind, (fn,)),) = op.cuda_fn.steps
    assert kind == "cuda" and fn.out_shape == (m, n)
    _assert_kernel_close(got, fn.plain({"X": x, "W": w}), f"zamba2 in_proj at {m} rows")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-125m"])
def test_wave_serves_the_families_on_the_card(name):
    """A 2-layer zamba2-2.7b (its one group: the shared block, then 6
    Mamba2 layers, as the reference builds ceil(2 / 6) groups of 6) and a
    2-layer xlstm-125m (an mLSTM and an sLSTM block) at full width, bf16,
    through ``WaveEngine`` on the card as the qwen3-moe test runs it:
    7 + 6 x 2 = 19 and 5 + 3 = 8 contraction launches a call.  xlstm's
    first logits are held free; zamba2's 7 blocks are held one by one on
    the same inputs, at the prefill and one decode step
    (``_hold_hybrid_blocks``)."""
    from repro_torch import configs

    _card()
    cfg = dataclasses.replace(configs.get(name), n_layers=2)
    if cfg.xlstm:
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, slstm_at=(1,)))
    _assert_wave_launches(_wave_calls(cfg), {"zamba2-2.7b": 19, "xlstm-125m": 8}[name],
                          free_logits=cfg.family != "hybrid")
    if cfg.family == "hybrid":
        _hold_hybrid_blocks(cfg)


# ------------------------------------------------------------- training
def _train_names():
    from repro_torch import configs

    return configs.names()


@pytest.mark.cuda
@pytest.mark.parametrize("name", _train_names())
def test_train_step_on_the_card_matches_the_cpu(name):
    """chip_smoke phase 13 (c): one float32 train step of the config at
    ``scaled()`` on the card against the CPU, from the same weights and
    batch: the loss within 1e-5 relative, each gradient leaf within
    1e-4 x (1 + its largest |g|) (``chip_smoke.card_against_cpu`` raises
    past them)."""
    from repro_torch import api

    _card()
    cs = _chip_smoke()
    row = cs.card_against_cpu(torch, api, name)
    assert row["loss_rel_err"] <= cs.STEP_LOSS_RTOL and row["grad_err"] <= cs.STEP_GRAD_RTOL


@pytest.mark.cuda
def test_fault_recovery_on_the_card(tmp_path):
    """chip_smoke phase 13 (d): a fault at step 6 of 12, a checkpoint
    every 4: steps 10-12 resume within 1e-6 of the uninterrupted run."""
    from repro_torch import api

    _card()
    cs = _chip_smoke()
    out = cs.fault_resume(torch, api, tmp_path, "cuda")
    assert out["restarts"] == 1 and out["max_rel_err"] <= cs.RESUME_RTOL


@pytest.mark.cuda
def test_kernels_refuse_autograd_on_the_card():
    """chip_smoke phase 13 (f), ROADMAP C11: ``oplib.linear`` on ``cuda``,
    ``flash_attention`` and ``chunked_gla`` on card tensors that require
    grad, and a ``Trainer`` under ``cuda``, raise before any launch."""
    from repro_torch import api

    _card()
    K.launches = 0
    assert _chip_smoke().c11_refusals(torch, api, "cuda") == [
        "oplib.linear", "flash_attention", "chunked_gla", "Trainer"]
    assert K.launches == 0


# --------------------------------------------------------- multi-device
# chip_smoke phase 14's programs at small widths whose plans keep their
# kinds on 4 ranks: a row split, a psum, a channel split, a halo split and
# (under the slow copy of h100) the ring
SMALL_MESH = dict(MESH_FFN=(256, 64, 128), MESH_DOWN=(15, 256, 31), MESH_CONV=(16, 12, 8, 8),
                  MESH_HALO=(16, 12, 8, 7), MESH_MLP2=(12, 64, 512, 64))


@pytest.mark.cuda
def test_mesh_cases_on_four_ranks_of_the_card(monkeypatch):
    """chip_smoke phase 14 (a) at small widths on ``Mesh(["cuda:0"] * 4)``:
    each plan's collectives as expected, no fallback, each output within
    1e-5 x (1 + max|single|) of the single-device ``cuda`` compile, the
    collective call sites equal to the plan's, the unit kernels launched
    ranks x segments' launches (``chip_smoke.mesh_cases`` raises past
    any of these)."""
    from repro_torch import api

    _card()
    cs = _chip_smoke()
    for k, v in SMALL_MESH.items():
        monkeypatch.setattr(cs, k, v)
    out = cs.mesh_cases(torch, api, cs._Timer(torch, 2), 2)
    rows = {r["case"]: r for r in out["rows"]}
    assert set(rows) == set(cs.MESH_PLANS)
    assert out["launches"]["contraction"]["launches"] >= 3 * cs.MESH_RANKS
    assert out["launches"]["windowed"]["launches"] >= 2 * cs.MESH_RANKS
    assert rows["conv2_x_halo"]["collective_sites"] == {"ppermute": 2, "all_gather": 1}
    assert rows["mlp2_ring"]["collective_trips"]["ppermute"] == cs.MESH_RANKS - 1


@pytest.mark.cuda
def test_collective_library_on_four_ranks_of_the_card(monkeypatch):
    """chip_smoke phase 14 (b) at small widths: both ring matmuls, decode
    attention, the pipeline, ZeRO-1 against AdamW and ``compressed_psum``
    on four ranks of the card, each against its single-device reference."""
    from repro_torch import api

    _card()
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "RING_ROWS", 64)
    monkeypatch.setattr(cs, "SP_DECODE", (4, 8, 2, 64, 1024))
    monkeypatch.setattr(cs, "PIPE_MICRO", 4)
    small = dataclasses.replace(api.configs.get("llama3-8b"), d_model=256, d_ff=512,
                                n_heads=4, n_kv_heads=2, head_dim=64)
    monkeypatch.setattr(api.configs, "get", lambda name: small)
    out = cs.collective_library(torch, api, cs._Timer(torch, 2))
    assert set(out) == {"ring_allgather_matmul", "ring_matmul_reduce_scatter",
                        "sp_decode_attention", "pipeline_apply", "zero1_update",
                        "compressed_psum"}


@pytest.mark.cuda
def test_a_mesh_count_beyond_the_cards_raises_on_the_card():
    """``resolve_mesh(8)`` on a machine with fewer cards raises, naming the
    explicit devices that emulate them; it never runs on the CPU."""
    from repro_torch import api
    from repro_torch.core import mesh_lower

    _card()
    n = torch.cuda.device_count() + 1
    if n <= 8:
        with pytest.raises(ValueError, match="explicit devices"):
            mesh_lower.resolve_mesh(8)
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        mesh_lower.resolve_mesh(n)
    assert "CUDA device" in _chip_smoke().mesh_without_cards(api) or n > 8


def _small_shard(monkeypatch):
    """chip_smoke's phase 15 at scaled() widths (2 layers, float32): the
    same helpers, the same holds; every sharded call limited to 60 s, well
    under the 300 s a collective waits by default."""
    from repro_torch import api

    cs = _chip_smoke()
    get = api.configs.get
    monkeypatch.setattr(api.configs, "get", lambda name: get(name).scaled(vocab=256))
    for k, v in {"SHARD_BATCH": 8, "SHARD_SEQ": 16, "SHARD_TIMEOUT": 60.0,
                 "SHARD_MAX_LEN": 32}.items():
        monkeypatch.setattr(cs, k, v)
    return cs, api


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama3-8b", "chatglm3-6b", "qwen3-moe-30b-a3b"])
def test_sharded_loss_and_grads_on_eight_ranks_of_the_card(monkeypatch, name):
    """``sharded_loss_and_grads`` on ``Mesh(["cuda:0"] * 8)`` (2, 4)
    against the single-device ``loss_and_grads`` on ``cuda:0``: the loss
    within rtol 2e-4, each gradient leaf within 1e-4 x (1 + max), the MoE
    with tokens dropped.  Every collective runs on the rank threads: one
    inside autograd would wait on the card's single backward thread until
    the call's time limit."""
    _card()
    cs, api = _small_shard(monkeypatch)
    row = cs.shard_train_case(torch, api, name, 2)
    assert row["loss_rel_err"] <= cs.SHARD_LOSS_RTOL and row["grad_err"] <= cs.SHARD_GRAD_RTOL
    assert row.get("dropped_pairs", 1) > 0


@pytest.mark.cuda
def test_sharded_train_step_on_eight_ranks_of_the_card(monkeypatch):
    """One ``sharded_train_step`` on (2, 4) ranks of the card against
    ``apply_updates_`` on one device: each parameter within 1e-5 x (1 +
    max)."""
    _card()
    cs, api = _small_shard(monkeypatch)
    assert cs.shard_step_case(torch, api, 2)["param_err"] <= cs.SHARD_PARAM_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch", [((1, 4), 4), ((2, 2), 1)])
def test_sharded_decode_launches_the_contraction_kernel_on_every_rank(monkeypatch, shape,
                                                                       batch):
    """Sharded prefill and 3 decode steps with oplib on ``cuda``: every
    rank launches 7 contraction kernels a layer a call on its shards (none
    on the general loop), counted per rank, but for a unit the legality
    check sends to torch and records (at one row a rank, the fused gate
    and silu: ROADMAP C17); the logits within 5e-2 of the row's largest of
    the single-device ``Model`` on the same tokens."""
    _card()
    cs, api = _small_shard(monkeypatch)
    from repro_torch.kernels import contraction as K

    cfg = api.configs.get("llama3-8b")
    params = api.build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    row = cs.shard_serve_case(torch, api, K, cfg, params, shape, batch, 8, 3)
    assert len(row["launches_by_rank"]) == shape[0] * shape[1]
    units = sum(c.get("torch_units", 0) for c in row["launches_by_rank"].values())
    assert row["launches"]["contraction"] + units == shape[0] * shape[1] * 7 * cfg.n_layers * 4
    assert units == 0 or all("not a grid index" in why for why in row["torch_units"].values())


@pytest.mark.cuda
def test_restore_with_shardings_on_the_card(monkeypatch, tmp_path):
    """A checkpoint saved from (2, 4) ranks of the card restores onto
    (1, 4) bit-equal."""
    _card()
    cs, api = _small_shard(monkeypatch)
    assert cs.shard_restore_case(torch, api, tmp_path)["bit_equal"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"])
def test_sharded_family_step_on_eight_ranks_of_the_card(monkeypatch, name):
    """The hybrid, ssm and audio families' ``sharded_loss_and_grads`` on
    (2, 4) ranks of the card against the single-device ``loss_and_grads``
    (loss within rtol 2e-4, each gradient leaf within 1e-4 x (1 + max)),
    then one ``sharded_train_step`` against ``apply_updates_`` (1e-5).
    Their new cuts (the gathers of ``in_proj``'s output, ``conv_w``,
    ``up_proj``, the sLSTM's gate weights, ``frame_proj``; cross-attention's
    ``memory`` entering each region) all run on the rank threads: one
    inside autograd would wait on the card's single backward thread."""
    _card()
    cs, api = _small_shard(monkeypatch)
    row = cs.shard_train_case(torch, api, name, 2, phase=16)
    assert row["loss_rel_err"] <= cs.SHARD_LOSS_RTOL and row["grad_err"] <= cs.SHARD_GRAD_RTOL
    step = cs.shard_step_case(torch, api, 2, name=name, phase=16)
    assert step["param_err"] <= cs.SHARD_PARAM_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,batch", [("zamba2-2.7b", (1, 4), 4),
                                              ("zamba2-2.7b", (2, 2), 1),
                                              ("xlstm-125m", (1, 4), 4),
                                              ("xlstm-125m", (2, 2), 1)])
def test_sharded_family_decode_on_ranks_of_the_card(monkeypatch, name, shape, batch):
    """Sharded prefill and 3 decode steps of zamba2 and xlstm with oplib on
    ``cuda``: one contraction launch a projection a rank a call (or a unit
    the legality check sends to torch, recorded), the recurrent states
    re-laid out around each call; the logits within 5e-2 of the row's
    largest of the single-device ``Model`` (zamba2's with every block of the
    sharded run fed the single run's input, each block's output held)."""
    _card()
    cs, api = _small_shard(monkeypatch)
    from repro_torch.kernels import contraction as K

    cfg = api.configs.get(name)
    params = api.build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    row = cs.shard_serve_case(torch, api, K, cfg, params, shape, batch, 8, 3, phase=16)
    assert len(row["launches_by_rank"]) == shape[0] * shape[1]
    units = sum(c.get("torch_units", 0) for c in row["launches_by_rank"].values())
    assert row["launches"]["contraction"] + units == (shape[0] * shape[1]
                                                      * len(cs._model_ops(cfg)) * 4)
    if name == "zamba2-2.7b":
        assert row["blocks_held"] > 0 and row["block_err_max"] <= cs.LOGIT_RTOL
