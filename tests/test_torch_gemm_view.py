"""The contraction kernel's GEMM view (``kernels.contraction.gemm_view``),
on the CPU.

* which path every unit of the full-width llama3-8b serving programs, the
  exploration corpus under ``h100`` (fused and not), the 1024-cube bf16
  and int8 matmuls and the ``prologue`` program takes, and why a refused
  plan runs the general loop;
* that the view's batch / M / N / K strides describe the plan: a
  reference built from them alone (``torch.as_strided`` and
  ``torch.einsum``) equals ``contraction_plain``, which the other tests
  hold against the JAX package;
* the split of K, the launch shapes and the ``path`` argument.

The kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core.driver import stripe_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.core.lower_torch import torch_dtype  # noqa: E402
from repro_torch.explore.workloads import get_workloads  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402


def _jit(prog, hw="h100"):
    if isinstance(hw, str):
        hw = get_config(hw)
    return stripe_jit(prog, hw, "cuda", cache=t_cache.CompilationCache(use_disk=False),
                      use_disk=False)


def _contraction_fns(compiled):
    return [(unit.name, fn) for unit, _kind, fns in compiled._fn.steps for fn in fns
            if fn.kernel == "contraction"]


def _arrays(plan, shapes, seed=0):
    """Random slot and epilogue tensors of ``plan`` (integers in [-3, 3])."""
    rng = np.random.RandomState(seed)

    def one(slot):
        shape = shapes[slot.buf]
        if slot.dtype.startswith("int"):
            a = torch.from_numpy(rng.randint(-3, 4, size=shape).astype(np.int64))
        else:
            a = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return a.to(torch_dtype(slot.dtype))

    return [one(s) for s in plan.slots], [one(s) for s in plan.eslots]


def view_reference(plan, view, slots, eslots, clip):
    """The plan computed from the view's strides alone: A[b, m, k] and
    B[b, n, k] by ``as_strided``, their product by ``einsum``, the scale
    and the epilogue on [b, m, n] tensors, rounded once into the region."""
    acc_t = torch_dtype(plan.acc)
    names = tuple(f"b{i}" for i in range(len(view.batch))) + ("m", "n")
    ext = dict(zip(names, view.batch_ext + (view.M, view.N)))

    def strided(t, base, bstr, sizes, strides):
        flat = t.to(acc_t).contiguous().reshape(-1)
        return torch.as_strided(flat, list(view.batch_ext) + sizes, list(bstr) + strides, base)

    a = strided(slots[view.a.slot], view.a.base, view.a.batch, [view.M, view.K],
                [view.a.s_mn, view.a.s_k])
    b = strided(slots[view.b.slot], view.b.base, view.b.batch, [view.N, view.K],
                [view.b.s_mn, view.b.s_k])
    acc = K.einsum_acc("...mk,...nk->...mn", a, b)
    ops = K._TensorOps(ext, acc.device, acc_t)
    if plan.scale != 1.0:
        acc = acc * ops.const(plan.scale)[0]
    val = (acc, names)
    if plan.epi:
        def along(es, var):
            return es.ostride[var] if var is not None else 0

        loads = [(strided(t, es.base, [es.ostride[v] for v in view.batch], [view.M, view.N],
                          [along(es, view.m), along(es, view.n)]), names)
                 for t, es in zip(eslots, plan.eslots)]
        val = K.run_postfix(plan.epi, loads, val, plan.consts, ops)
    res = val[0].expand([ext[v] for v in names])
    region = torch.zeros(plan.out_shape, dtype=torch_dtype(plan.out_dtype))
    rstr = K._row_strides(plan.out_shape)
    vars_ = list(view.batch) + [view.m, view.n]
    strides = [0 if v is None else plan.out_coef[v] * rstr[plan.out_dim[v]] for v in vars_]
    torch.as_strided(region, list(res.shape), strides).copy_(res)
    return region[tuple(slice(0, c) for c in clip)]


# ------------------------------------------------------- the test programs
def _prog(name):
    tp = TileProgram(name)
    if name == "chain":
        tp.input("A", (16, 12)); tp.input("B", (12, 24)); tp.input("b", (24,))
        tp.temp("T", (16, 24)); tp.output("G", (16, 24))
        tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm1")
        tp.op("G[i, j] = gelu(T[i, j] + b[j])", name="bias_act")
    elif name == "scores":  # GQA: b and k are read by both operands
        tp.input("Q", (3, 2, 2, 16)); tp.input("K", (3, 40, 2, 16))
        tp.output("S", (3, 2, 2, 40))
        tp.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    elif name == "values":
        tp.input("P", (3, 2, 2, 40)); tp.input("V", (3, 40, 2, 16))
        tp.output("O", (3, 2, 2, 16))
        tp.op("O[b, k, g, d] += P[b, k, g, t] * V[b, t, k, d]", name="values")
    elif name == "transposed":  # A unit-stride along M, B along K
        tp.input("A", (23, 37)); tp.input("B", (29, 23)); tp.output("O", (37, 29))
        tp.op("O[i, j] += A[c, i] * B[j, c]", name="mm")
    elif name == "ragged":
        tp.input("A", (37, 19)); tp.input("B", (19, 45)); tp.input("R", (37, 45))
        tp.temp("T", (37, 45)); tp.output("O", (37, 45))
        tp.op("T[i, j] += A[i, c] * B[c, j]", name="mm")
        tp.op("O[i, j] = T[i, j] + R[i, j]", name="resid")
    elif name == "scaled":
        tp.input("A", (19, 23)); tp.input("B", (23, 17)); tp.output("O", (19, 17))
        tp.op("O[i, j] += 0.125 * A[i, c] * B[c, j]", name="mm")
    elif name == "skinny_rhs":  # M only on the rhs: the view swaps the sides
        tp.input("W", (64, 40)); tp.input("X", (40, 3)); tp.output("O", (64, 3))
        tp.op("O[i, j] += W[i, c] * X[c, j]", name="mm")
    elif name == "int8":
        tp.input("A", (33, 40), "int8"); tp.input("B", (40, 20), "int8")
        tp.output("O", (33, 20), "int32")
        tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    elif name == "bf16":
        tp.input("A", (40, 24), "bfloat16"); tp.input("B", (24, 36), "bfloat16")
        tp.output("O", (40, 36), "bfloat16")
        tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    elif name == "prologue":
        tp.input("X", (16, 12)); tp.input("W", (12, 24))
        tp.temp("X2", (16, 12)); tp.output("O", (16, 24))
        tp.op("X2[i, c] = gelu(X[i, c])", name="pre")
        tp.op("O[i, j] += X2[i, c] * W[c, j]", name="mm")
    return tp.build()


def _cube(dtype, n=1024):
    tp = TileProgram(f"mm_{dtype}")
    tp.input("A", (n, n), dtype)
    tp.input("B", (n, n), dtype)
    tp.output("O", (n, n), "int32" if dtype == "int8" else dtype)
    tp.op("O[i, j] += A[i, c] * B[c, j]", name="mm")
    return tp.build()


VIEW_PROGRAMS = ("chain", "scores", "values", "transposed", "ragged", "scaled", "skinny_rhs",
                 "int8", "bf16")


# ------------------------------------------------------------ which path
def test_full_width_serving_units_take_their_paths():
    """llama3-8b at full width under h100: every decode unit (4 rows, KV
    window 256) is skinny, every prefill unit (128 rows) tiled on the CUDA
    cores, and nothing falls to the general loop."""
    from repro_torch.serving import stripe_decode as sd

    cfg = t_configs.get("llama3-8b")
    jc = sd.EngineLikeConfig(hw=get_config("h100"), backend="cuda", use_disk=False,
                             cache=t_cache.CompilationCache(use_disk=False))
    seen = {}
    for m, window, path, mma in ((4, 256, "skinny", "fma"), (128, None, "tiled", "ffma")):
        progs = sd.build_programs(cfg, m, jc, kv_window=window)
        for pname in ("qkv", "attn_out", "mlp", "scores", "values"):
            prog = getattr(progs, pname)
            if prog is None:
                continue
            for unit, fn in _contraction_fns(prog):
                view = K.gemm_view(fn.plan)
                assert view is not None, (m, unit, K.refusal(fn.plan))
                assert (view.path, view.mma) == (path, mma), (m, unit)
                assert K.plan_path(fn.plan) == path and K.refusal(fn.plan) is None
                seen[m, pname, unit] = view
    assert len(seen) == 16
    for (m, pname, unit), view in seen.items():
        if m == 4:
            assert view.M == 4 and view.tile[0] == 4 and view.a.load == "ld"
            assert view.b.load == "cp.async16", unit
            # the K cache is read along the head dim, the V cache along N
            assert view.kv == (pname == "scores"), unit
            if pname in ("scores", "values"):
                assert view.batch_ext == (4, 8) and view.M == 4
        else:
            assert view.M == 128 and (view.a.load, view.b.load) == ("cp.async4", "cp.async16")
            # one wave fills most of the 132 SMs: 112 tiles of 128 x 128
            # alone (N = 14336), or 8-32 tiles with K split
            assert view.blocks() >= 112 and (view.splits > 1 or view.N == 14336), unit


# (program, unit name before any "+") -> (path, mma or the refusal's words)
CORPUS_PATHS = {
    ("mm_bias_gelu", "mm"): ("tiled", "wgmma", ("tma", "tma-mn")),
    ("ffn_relu2", "mm1"): ("tiled", "wgmma", ("tma", "tma-mn")),
    ("ffn_relu2", "mm2"): ("tiled", "ffma", ("cp.async4", "ld")),
    ("attn_scores", "op0"): ("tiled", "wgmma", ("tma", "tma")),
    ("moe_ffn", "up"): ("tiled", "wgmma", ("tma", "tma-mn")),
    ("moe_ffn", "gate_mm"): ("tiled", "wgmma", ("tma", "tma-mn")),
    ("moe_ffn", "down"): ("tiled", "ffma", ("cp.async4", "ld")),
    ("conv_mlp", "proj"): ("general", "2 M, 1 N and 1 K variables", None),
}


@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "no-fuse"])
def test_corpus_units_take_their_paths(fuse):
    corpus = {w.name: w for w in get_workloads("all")}
    hw = get_config("h100")
    if not fuse:
        hw = hw.without_pass("fuse")
    names = [w.name for w in get_workloads("default")] + ["conv_mlp"]
    found = set()
    for name in names:
        for unit, fn in _contraction_fns(_jit(corpus[name].build(), hw)):
            key = (name, unit.split("+")[0])
            path, how, loads = CORPUS_PATHS[key]
            found.add(key)
            assert K.plan_path(fn.plan) == path, key
            view = K.gemm_view(fn.plan)
            if path == "general":
                assert view is None and how in K.refusal(fn.plan), (key, K.refusal(fn.plan))
            else:
                assert view.mma == how and (view.a.load, view.b.load) == loads, key
    assert found == set(CORPUS_PATHS)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cubes_run_tiled_on_wgmma(dtype):
    (unit, fn), = _contraction_fns(_jit(_cube(dtype)))
    view = K.gemm_view(fn.plan)
    assert (view.path, view.mma) == ("tiled", "wgmma")
    assert (view.M, view.N, view.K) == (1024, 1024, 1024) and view.splits == 1
    # A is K-major and read in place by TMA; B is N-major: read in place
    # and transposed by wgmma in bf16, packed K-major in int8
    assert (view.a.unit, view.b.unit) == ("k", "mn")
    assert view.tile == (128, 128, 128 // (1 if dtype == "int8" else 2))
    if dtype == "int8":
        assert (view.a.load, view.b.load) == ("tma", "pack+tma")
        assert view.work() == (1024 * view.k_packed(view.b), -1, -1, 0)
    else:
        assert (view.a.load, view.b.load) == ("tma", "tma-mn")
        assert view.work() == (0, -1, -1, -1)


def test_prologue_program_runs_the_general_loop():
    fns = _contraction_fns(_jit(_prog("prologue")))
    assert fns
    for _unit, fn in fns:
        assert K.gemm_view(fn.plan) is None and K.plan_path(fn.plan) == "general"
        assert "prologue" in K.refusal(fn.plan)


def test_a_skinny_rhs_swaps_the_sides():
    (_unit, fn), = _contraction_fns(_jit(_prog("skinny_rhs")))
    view = K.gemm_view(fn.plan)
    assert view.swapped and view.path == "skinny" and (view.M, view.N) == (3, 64)
    assert view.a.slot == 1 and view.b.slot == 0


def test_alignment_decides_the_loads():
    """Operands that do not start at a 16-byte boundary lose the 16-byte
    copies (skinny, tiled float32) and the in-place TMA reads (wgmma)."""
    (_u, cube), = _contraction_fns(_jit(_cube("bfloat16", 256)))
    assert K.gemm_view(cube.plan, aligned=(False, True)).a.load == "pack+tma"
    (_u, ragged), = _contraction_fns(_jit(_prog("ragged")))
    view = K.gemm_view(ragged.plan)
    assert view.mma == "ffma" and view.b.load == "cp.async4"  # 45-float rows
    (_u, skinny), = _contraction_fns(_jit(_prog("skinny_rhs")))
    view = K.gemm_view(skinny.plan)  # B is the plan's lhs W[i, c]: rows of 40 floats
    assert view.kv and view.b.unit == "k" and view.b.load == "cp.async16"
    assert K.gemm_view(skinny.plan, aligned=(False, True)).b.load == "ld"


# -------------------------------------------------- the view's strides
@pytest.mark.parametrize("hw", ["h100", "tpu_v5e"])
@pytest.mark.parametrize("name", VIEW_PROGRAMS)
def test_view_strides_reproduce_the_plain_version(name, hw):
    prog = _prog(name)
    fns = _contraction_fns(_jit(prog, hw))
    assert fns
    shapes = {k: d.shape for k, d in prog.buffers.items()}
    for i, (unit, fn) in enumerate(fns):
        plan = fn.plan
        view = K.gemm_view(plan)
        assert view is not None, (unit, K.refusal(plan))
        slots, eslots = _arrays(plan, shapes, seed=i)
        clips = [plan.out_shape]
        if all(e > 1 for e in plan.out_shape):
            clips.append(tuple(e - 1 for e in plan.out_shape))  # a ragged clip
        for clip in clips:
            got = view_reference(plan, view, slots, eslots, clip)
            want = K.contraction_plain(plan, slots, eslots, clip)
            assert got.dtype == want.dtype and got.shape == want.shape
            if want.dtype.is_floating_point:
                torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(got, want), (unit, clip)


@pytest.mark.parametrize("name", VIEW_PROGRAMS)
def test_split_k_covers_k_once(name):
    for _unit, fn in _contraction_fns(_jit(_prog(name))):
        view = K.gemm_view(fn.plan)
        bk = view.tile[2]
        assert view.k_split % bk == 0
        assert (view.splits - 1) * view.k_split < view.K <= view.splits * view.k_split
        if view.mma == "wgmma":
            assert view.splits == 1
        if view.path == "skinny":
            assert view.M <= view.tile[0] <= K.SKINNY_ROWS
            assert view.tile[0] * view.k_split <= K.SKINNY_X
        total, part, _pa, _pb = view.work()
        assert (part >= 0) == (view.splits > 1 or view.deferred)
        assert view.deferred == (view.path == "tiled" and view.splits == 1
                                 and bool(fn.plan.epi))
        if view.splits > 1:
            assert total >= view.splits * view.nbatch * view.M * view.N * 4


def test_launch_shape_per_path():
    (_u, chain), = _contraction_fns(_jit(_prog("chain")))
    (_u, cube), = _contraction_fns(_jit(_cube("bfloat16", 256)))
    (_u, skinny), = _contraction_fns(_jit(_prog("skinny_rhs")))
    assert K.launch_shape(cube.plan) == ((288, 1), 4)
    assert K.launch_shape(skinny.plan)[0] == (256, 1)
    assert K.launch_shape(chain.plan)[0] == (256, 1)
    (bx, tk), blocks = K.launch_shape(chain.plan, "general")
    assert bx * tk <= 1024 and blocks * bx >= 16


def test_path_argument_on_cpu_tensors():
    """On CPU tensors any path is the plain version, and nothing counts as
    a launch; an unknown path is refused."""
    prog = _prog("chain")
    (_u, fn), = _contraction_fns(_jit(prog))
    slots, eslots = _arrays(fn.plan, {k: d.shape for k, d in prog.buffers.items()})
    before = dict(K.launches_by_path), K.launches
    want = K.contraction_plain(fn.plan, slots, eslots)
    for path in (None, "general"):
        torch.testing.assert_close(K.contraction(fn.plan, slots, eslots, path=path), want)
    assert (dict(K.launches_by_path), K.launches) == before
    assert set(K.launches_by_path) == {"skinny", "tiled", "general"}
    with pytest.raises(ValueError, match="path"):
        K.contraction(fn.plan, slots, eslots, path="skinny")


def test_params_carry_the_view():
    """The launch parameters hold the view's fields; ``path="general"``
    clears them."""
    (_u, fn), = _contraction_fns(_jit(_prog("scores")))
    plan = fn.plan
    view = K.gemm_view(plan)
    p, blocks, got = K._params(plan, plan.out_shape)
    assert got is view and blocks == view.blocks()
    assert p.path == K.PATH_SKINNY and (p.g_M, p.g_N, p.g_K) == (view.M, view.N, view.K)
    assert p.g_nb == 2 and p.g_nbatch == math.prod(view.batch_ext) == 6
    assert [p.g_bext[i] for i in range(2)] == list(view.batch_ext)
    assert p.kv == 1 and p.mt == 4
    g, _blocks, none = K._params(plan, plan.out_shape, "general")
    assert g.path == K.PATH_GENERAL and none is None
