"""The windowed kernel's implicit-GEMM view (``kernels.windowed.conv_view``),
on the CPU.

* which path every windowed unit of ResNet-50's conv2_x layer (float32,
  bf16 and int8; batch 8 and 1) and of the corpus convs (``fig4_conv``,
  ``fig5_conv_f32``, ``conv_mlp``) takes under ``h100``, ``cpu_test`` and
  ``tpu_v5e``, fused and not, and why a refused plan runs the general
  loop;
* that the view's M / N / K strides and its zero-fill rule describe the
  plan: a reference built from them alone (the input padded, an
  ``as_strided`` im2col, the guards as a mask, ``torch.einsum``) equals
  ``windowed_plain``, which tests/test_torch_windowed.py holds against the
  JAX package: int8 bit-exact, float32 within 1e-5 of the largest output
  (sums in another order), bf16 within one bf16 step of it (both round
  one float32 sum once);
* the ``path`` argument on CPU tensors.

The kernel's igemm path itself runs only on the card
(tests/test_torch_cuda.py).

    PYTHONPATH=src python -m pytest -q tests/test_torch_conv_view.py
"""
import functools
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core.driver import stripe_jit  # noqa: E402
from repro_torch.core.frontend import single_op_program  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.core.lower_torch import torch_dtype  # noqa: E402
from repro_torch.explore.workloads import get_workloads, resnet50_conv2_3x3  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402
from repro_torch.kernels import windowed as WK  # noqa: E402

RESNET = [f"resnet_b{b}_{dt}" for b in (8, 1) for dt in ("float32", "bfloat16", "int8")]
CORPUS = ["fig4_conv", "fig5_conv_f32", "conv_mlp"]


def _program(name):
    if name.startswith("resnet_"):
        _, b, dt = name.split("_", 2)
        return resnet50_conv2_3x3(int(b[1:]), dt)
    if name.startswith("ragged_"):
        # 40 filters: under h100 a remainder over N whose filter columns
        # end inside its tile; 32 channels: a bf16 K stage spans two taps
        dt = name.split("_", 1)[1]
        return single_op_program(
            "O[n, x, y, k] += I[n, x + i - 1, y + j - 1, c] * F[i, j, c, k]",
            {"I": ((2, 13, 21, 32), dt), "F": ((3, 3, 32, 40), dt),
             "O": ((2, 13, 21, 40), "int32" if dt == "int8" else dt)}, out="O", name=name)
    return {w.name: w for w in get_workloads("all")}[name].build()


@functools.lru_cache(maxsize=None)
def _compiled(name, hw, fuse):
    config = get_config(hw) if fuse else get_config(hw).without_pass("fuse")
    return stripe_jit(_program(name), config, "cuda",
                      cache=t_cache.CompilationCache(use_disk=False), use_disk=False)


def _windowed_fns(compiled):
    """The windowed units of a compiled program (none where the whole
    program fell back to the torch backend)."""
    steps = getattr(compiled._fn, "steps", ())
    return [fn for _u, kind, fns in steps if kind == "cuda" for fn in fns
            if fn.kernel == "windowed"]


# ------------------------------------------------------------- the paths
@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "no-fuse"])
@pytest.mark.parametrize("hw", ["h100", "cpu_test", "tpu_v5e"])
@pytest.mark.parametrize("name", RESNET + CORPUS)
def test_windowed_units_take_their_paths(name, hw, fuse):
    c = _compiled(name, hw, fuse)
    fns = _windowed_fns(c)
    window = "1:i"
    if name == "resnet_b1_float32" and hw == "tpu_v5e":
        # the reference's tiling there cuts the 3-tap window 2 + 2, an
        # input offset (``2*i + 32*x - 1``) that lower_pallas.py refuses;
        # the port takes it: the boundary pass's two pieces of each output
        # region join into one launch over the 3 taps (``_joined_windowed``)
        assert c.record.block_backends == {"op0": "cuda"} and len(fns) == 2
        window = "1:i_t"
        for fn in fns:
            assert fn.plan.red_ext[fn.plan.red_vars.index(window)] == 3
    assert fns, c.record.fallback_reasons()
    for fn in fns:
        plan, view = fn.plan, WK.conv_view(fn.plan)
        if name == "fig4_conv":
            # 8 int8 channels are 8 bytes of an input row: no 16-byte copy
            assert view is None and WK.plan_path(plan) == "general"
            assert WK.refusal(plan) == ("the inner reduction variable 1:c spans 8 bytes of an "
                                        "input row, not whole 16-byte copies")
            continue
        assert WK.refusal(plan) is None and WK.plan_path(plan) == "igemm"
        dtype = plan.ins[0].dtype
        assert view.mma == ("ffma" if dtype == "float32" else "wgmma")
        assert view.b_load == {"float32": "cp.async16", "bfloat16": "tma-mn",
                               "int8": "pack+tma"}[dtype]
        assert view.tile == (128, 64, 128 // WK._SIZE[dtype]) and view.stages in (3, 4)
        channels = 64 if name.startswith("resnet_") else 8
        filters = 64 if name.startswith("resnet_") else 16
        assert (view.kc, view.K, view.N) == (channels, 9 * channels, filters)
        # the input (slot 0) is A; N is the output-channel variable k, K
        # walks c, then the taps j (fastest) and i; M every other variable
        assert view.a == 0 and plan.out_vars[view.n].split(":")[1].startswith("k")
        assert [plan.red_vars[t] for t in view.taps] == ["1:j", window]
        assert sorted(view.m_vars + (view.n,)) == [i for i, e in enumerate(plan.out_ext)
                                                   if e > 1]
        assert view.M == plan.output_points() // view.N
        assert view.tiles() == math.ceil(view.M / 128) * math.ceil(view.N / 64)
        assert view.blocks() == view.tiles() * view.splits


@pytest.mark.parametrize("dt,splits", [("float32", [1, 9, 9, 9]), ("bfloat16", [1, 3, 3, 3]),
                                       ("int8", [1, 2, 2, 2])])
def test_k_splits_over_ctas_where_the_tiles_are_few(dt, splits):
    """conv2_x under h100: the interior's 144 tiles fill the card and run
    whole; the strips' 24 tiles and the corner's 4 split K (at least 2
    stages a split), and the splits cover K once, in whole stages."""
    views = sorted((WK.conv_view(fn.plan) for fn in _windowed_fns(_compiled(
        f"resnet_b8_{dt}", "h100", True))), key=lambda v: -v.M)
    assert [v.splits for v in views] == splits
    for v in views:
        bk = v.tile[2]
        assert v.k_split % bk == 0 and (v.splits - 1) * v.k_split < v.K <= v.splits * v.k_split
        assert v.splits == 1 or v.k_split >= 2 * bk
        assert v.blocks() == v.tiles() * v.splits


def test_resnet_units_under_h100_are_the_four_pieces():
    """conv2_x at batch 8 under h100: an interior of 8x48x48 rows, strips
    of 8x48x8 and 8x8x48 and an 8x8x8 corner, each with padding
    constraints over M and the taps."""
    for dt in ("float32", "bfloat16", "int8"):
        fns = _windowed_fns(_compiled(f"resnet_b8_{dt}", "h100", True))
        assert sorted(WK.conv_view(fn.plan).M for fn in fns) == [512, 3072, 3072, 18432]
        for fn in fns:
            assert len(fn.plan.constraints) == 2
            assert all(c[1][WK.conv_view(fn.plan).n] == 0 for c in fn.plan.constraints)


def _plan(**kw):
    """A 1-D conv O[x, k] += I[x + i - 1, c] * F[i, c, k] as a plan, with
    fields replaced by ``kw``."""
    base = dict(
        out_vars=("k", "x"), out_ext=(16, 10), out_dim=(1, 0), out_coef=(1, 1),
        out_shape=(10, 16), red_vars=("c", "i"), red_ext=(8, 3),
        ins=(WK.WinInput("I", (10, 8), "float32", ((-1, (0, 1), (0, 1)), (0, (0, 0), (1, 0)))),
             WK.WinInput("F", (3, 8, 16), "float32",
                         ((0, (0, 0), (0, 1)), (0, (0, 0), (1, 0)), (0, (1, 0), (0, 0))))),
        constraints=(), lhs=((0, 0),), rhs=((0, 1),), n_sides=2, consts=(), scale=1.0,
        taps=("i",))
    base.update(kw)
    return WK.WinPlan(**base)


def test_view_refusals():
    ok = _plan()
    assert WK.conv_view(ok) is not None and WK.conv_view(ok).M == 10
    assert "not two plain loads" in WK.refusal(_plan(lhs=((0, 0), (16, 0))))
    assert "igemm takes no" in WK.refusal(_plan(ins=(
        ok.ins[0], WK.WinInput("F", (3, 8, 16), "bfloat16", ok.ins[1].dims))))
    # a variable both inputs read is a batch variable
    both = WK.WinInput("F", (3, 8, 16), "float32",
                       ((0, (0, 0), (0, 1)), (0, (0, 0), (1, 0)), (0, (1, 1), (0, 0))))
    assert "read by both inputs" in WK.refusal(_plan(ins=(ok.ins[0], both)))
    # a constraint over N and a tap; one over N alone ends the columns
    assert "moves the N variable k and another" in WK.refusal(
        _plan(constraints=((5, (-1, 0), (0, 1)),)))
    assert WK.conv_view(_plan(constraints=((5, (-1, 0), (0, 0)),))).nb == 6
    # the input read with channel stride 2
    strided = WK.WinInput("I", (10, 16), "float32", ((-1, (0, 1), (0, 1)), (0, (0, 0), (2, 0))))
    assert "stride 2 in the input, not 1" in WK.refusal(_plan(ins=(strided, ok.ins[1])))
    # 6 float32 channels: 24 bytes
    six = _plan(red_ext=(6, 3), ins=(WK.WinInput("I", (10, 6), "float32", ok.ins[0].dims),
                                     WK.WinInput("F", (3, 6, 16), "float32", ok.ins[1].dims)))
    assert "spans 24 bytes" in WK.refusal(six)
    # 65 taps
    wide = _plan(red_ext=(8, 65), ins=(
        WK.WinInput("I", (74, 8), "float32", ok.ins[0].dims),
        WK.WinInput("F", (65, 8, 16), "float32", ok.ins[1].dims)))
    assert "65 taps exceed the 64 bits" in WK.refusal(wide)
    # a tensor off a 16-byte boundary (the launch knows)
    assert WK.conv_view(ok, aligned=(False, True)) is None
    assert WK.conv_view(ok, aligned=(True, False)).b_load == "pack+cp.async16"
    assert WK.refusal(ok) is None and WK.plan_path(ok) == "igemm"
    assert "16-byte boundaries" in WK.refusal(ok, aligned=(False, True))
    assert WK.plan_path(ok, aligned=(False, True)) == "general"


def test_input_alignment_is_what_the_launch_sees():
    """``input_alignment`` reads the inputs as the launch does: a
    contiguous tensor that starts off a 16-byte boundary is misaligned; a
    non-contiguous one counts as aligned, since the launch copies it."""
    buf = torch.zeros(64, dtype=torch.float32)
    whole, off = buf[:16], buf[1:17]
    assert WK.input_alignment([whole, whole]) == (True, True)
    assert WK.input_alignment([off, whole]) == (False, True)
    assert WK.input_alignment([whole, off]) == (True, False)
    assert WK.input_alignment([buf[1::2], whole]) == (True, True)
    assert WK.input_alignment([whole]) == (True, False)


def test_filter_loads_follow_its_layout():
    """A filter stored [k][i][c] (K-major): bf16 reads it in place by TMA,
    float32 packs it N-major, and int8 reads it in place where its rows
    lie 16 bytes apart; an N-major int8 filter is packed K-major (8-bit
    wgmma reads K-major only)."""
    def plan(dt, c, kmajor=True):
        i_dims = ((-1, (0, 1), (0, 1)), (0, (0, 0), (1, 0)))
        f_dims = ((0, (0, 0), (0, 1)), (0, (0, 0), (1, 0)), (0, (1, 0), (0, 0)))
        f = (WK.WinInput("F", (16, 3, c), dt, (f_dims[2], f_dims[0], f_dims[1])) if kmajor
             else WK.WinInput("F", (3, c, 16), dt, f_dims))
        return _plan(red_ext=(c, 3), ins=(WK.WinInput("I", (10, c), dt, i_dims), f),
                     out_dtype="int32" if dt == "int8" else dt)

    assert WK.conv_view(plan("bfloat16", 8)).b_load == "tma"
    assert WK.conv_view(plan("bfloat16", 8, kmajor=False)).b_load == "tma-mn"
    assert WK.conv_view(plan("int8", 16)).b_load == "tma"
    assert WK.conv_view(plan("int8", 16, kmajor=False)).b_load == "pack+tma"
    v = WK.conv_view(plan("int8", 16, kmajor=False))
    assert (v.b_sk, v.b_sn, v.k_padded(), v.work("int8")) == (1, 128, 128, (16 * 128, 16 * 128))
    v = WK.conv_view(plan("float32", 8))
    assert (v.b_load, v.b_sk, v.b_sn, v.work("float32")) == ("pack+cp.async16", 16, 1,
                                                             (24 * 16 * 4, 24 * 16 * 4))


# ------------------------------------------------ the view's strides alone
def view_reference(plan, view, ins, clip):
    """The plan computed from the view alone: A[m, k] gathered from the
    zero-padded input by ``as_strided`` (the im2col), zeroed where a guard
    fails at (row, tap), B[k, n] from the filter's strides, their product
    by ``einsum``, the scale, and one rounding into the region."""
    acc_t = torch_dtype(plan.acc)
    q = WK._tracked(plan)
    a, b = view.a, 1 - view.a
    mv = list(reversed(view.m_vars))   # slowest first: row-major order
    tv = list(reversed(view.taps))
    m_ext = [plan.out_ext[i] for i in mv]
    t_ext = [plan.red_ext[j] for j in tv]
    # pad the flattened input so every gathered offset lies inside it (the
    # guards zero those that lie outside the input's dimensions)
    flat = ins[a].to(acc_t).contiguous().reshape(-1)
    sizes = m_ext + t_ext + [view.kc]
    strides = [q[a][1][i] for i in mv] + [q[a][2][j] for j in tv] + [1]
    lo = q[a][0] + sum(min(0, s * (e - 1)) for s, e in zip(strides, sizes))
    hi = q[a][0] + sum(max(0, s * (e - 1)) for s, e in zip(strides, sizes))
    pad_lo = max(0, -lo)
    padded = torch.nn.functional.pad(flat, (pad_lo, max(0, hi + 1 - flat.numel())))
    A = torch.as_strided(padded, sizes, strides, q[a][0] + pad_lo).reshape(view.M, view.K)
    # the guards at (row, tap): checked coordinates in range, constraints live
    n_slot, n_chk = len(plan.ins), len(plan.checked())
    grid = torch.meshgrid(*[torch.arange(e) for e in m_ext + t_ext], indexing="ij")
    live = torch.ones(m_ext + t_ext, dtype=torch.bool)
    for g, (const, oc, rc) in enumerate(q[n_slot:]):
        val = const + sum(c * x for c, x in zip([oc[i] for i in mv] + [rc[j] for j in tv], grid))
        live &= val >= 0
        if g < n_chk:
            s, d, _ = plan.checked()[g]
            live &= val < plan.ins[s].shape[d]
    mask = live.reshape(view.M, -1).repeat_interleave(view.kc, dim=1)
    A = torch.where(mask, A, torch.zeros((), dtype=acc_t))
    # the filter's first nb columns, zeros past them (a remainder over N)
    Bt = torch.as_strided(ins[b].to(acc_t).contiguous(), t_ext + [view.kc, view.nb],
                          [q[b][2][j] for j in tv] + [q[b][2][0], q[b][1][view.n]],
                          q[b][0]).reshape(view.K, view.nb)
    Bt = torch.nn.functional.pad(Bt, (0, view.N - view.nb))
    C = K.einsum_acc("mk,kn->mn", A, Bt)
    if plan.scale != 1.0:
        C = C * plan.scale
    region = torch.zeros(plan.out_shape, dtype=acc_t)
    rstr = K._row_strides(plan.out_shape)
    out_strides = [plan.out_coef[i] * rstr[plan.out_dim[i]] for i in mv + [view.n]]
    torch.as_strided(region, m_ext + [view.N], out_strides).copy_(
        C.reshape(m_ext + [view.N]))
    return region.to(torch_dtype(plan.out_dtype))[tuple(slice(0, c) for c in clip)]


def _inputs(plan, seed):
    rng = np.random.RandomState(seed)
    out = []
    for inp in plan.ins:
        if inp.dtype == "int8":
            a = torch.from_numpy(rng.randint(-100, 101, size=inp.shape).astype(np.int8))
        else:
            a = torch.from_numpy(rng.randn(*inp.shape).astype(np.float32))
        out.append(a.to(torch_dtype(inp.dtype)))
    return out


@pytest.mark.parametrize("name,hw", [
    (name, hw) for hw in ("h100", "cpu_test")
    for name in ("resnet_b1_float32", "resnet_b1_bfloat16", "resnet_b1_int8", "fig5_conv_f32",
                 "conv_mlp")] + [("ragged_int8", "h100"), ("ragged_bfloat16", "h100")])
def test_view_strides_reproduce_the_plain_version(name, hw):
    """Both references, the view's strides and the kernel's gather
    tables, equal the plain version."""
    fns = _windowed_fns(_compiled(name, hw, True))
    assert fns
    for seed, fn in enumerate(fns):
        plan, view = fn.plan, WK.conv_view(fn.plan)
        clip = getattr(fn, "out_clip", fn.out_shape)
        ins = _inputs(plan, seed)
        want = WK.windowed_plain(plan, ins, clip)
        for ref in (view_reference, table_reference):
            got = ref(plan, view, ins, clip)
            assert got.dtype == want.dtype and got.shape == want.shape
            if not got.dtype.is_floating_point:
                assert torch.equal(got, want), (ref.__name__, fn.plan.out_ext)
                continue
            scale = want.float().abs().max().item()
            tol = 1e-5 if got.dtype == torch.float32 else 2.0 ** -8
            assert (got.float() - want.float()).abs().max().item() <= tol * scale, ref.__name__


def table_reference(plan, view, ins, clip):
    """The plan computed from what the kernel reads, the gather tables of
    ``igemm_tables``: A[m, c + kc * t] = input[rows[0, m] + taps[t] + c]
    where bit t of rows[2, m] is set, else 0; B[k, n] = filter[b_rows[k] +
    n * stride] for n below nb, else 0; each row stored at rows[1, m]
    (none at -1) along N's output stride, inside the clip."""
    acc_t = torch_dtype(plan.acc)
    rows, taps, b_rows = WK.igemm_tables(plan, view, clip)
    flat = ins[view.a].to(acc_t).contiguous().reshape(-1)
    k = torch.arange(view.K)
    t, c = k // view.kc, k % view.kc
    idx = rows[0][:, None] + taps[t][None, :] + c[None, :]
    live = ((rows[2][:, None] >> t[None, :]) & 1).bool()
    A = torch.where(live, flat[idx.clamp(0, flat.numel() - 1)], torch.zeros((), dtype=acc_t))
    b = 1 - view.a
    b_flat = ins[b].to(acc_t).contiguous().reshape(-1)
    Bt = b_flat[b_rows[:, None] + WK._tracked(plan)[b][1][view.n] * torch.arange(view.nb)[None, :]]
    C = K.einsum_acc("mk,kn->mn", A, torch.nn.functional.pad(Bt, (0, view.N - view.nb)))
    if plan.scale != 1.0:
        C = C * plan.scale
    d, coef = plan.out_dim[view.n], plan.out_coef[view.n]
    nlim = min(view.N, -(-clip[d] // coef))
    region = torch.zeros(math.prod(clip), dtype=acc_t)
    keep = rows[1] >= 0
    out = rows[1][keep][:, None] + coef * K._row_strides(clip)[d] * torch.arange(nlim)[None, :]
    region[out.reshape(-1)] = C[keep][:, :nlim].reshape(-1)
    return region.reshape(clip).to(torch_dtype(plan.out_dtype))


def test_view_reference_sees_a_clip_and_a_scale():
    """A clip smaller than the unit's region and a scale: both references
    and the plain version cut and scale alike."""
    plan = _plan(scale=0.5, constraints=((8, (0, -1), (0, -1)),))
    view = WK.conv_view(plan)
    ins = _inputs(plan, 3)
    for clip in ((10, 16), (7, 16), (10, 11)):
        want = WK.windowed_plain(plan, ins, clip)
        for ref in (view_reference, table_reference):
            torch.testing.assert_close(ref(plan, view, ins, clip), want, rtol=1e-6, atol=1e-6)


def test_gather_tables():
    """The row table of the 1-D conv: offsets x - 1 rows of 8 channels,
    the tap mask of x + i - 1 inside [0, 10) and the constraint x + i <= 8,
    and rows past the clip stored nowhere."""
    plan = _plan(constraints=((8, (0, -1), (0, -1)),))
    view = WK.conv_view(plan)
    rows, taps, b_rows = WK.igemm_tables(plan, view, (7, 16))
    assert rows.shape == (3, 10) and taps.tolist() == [0, 8, 16]
    # F[i, c, k]: c strides 16, i strides 128
    assert b_rows.tolist() == [16 * c + 128 * i for i in range(3) for c in range(8)]
    assert rows[0].tolist() == [8 * (x - 1) for x in range(10)]
    assert rows[1].tolist() == [16 * x for x in range(7)] + [-1] * 3
    want = [sum(1 << i for i in range(3) if 0 <= x + i - 1 < 10 and x + i <= 8)
            for x in range(10)]
    assert rows[2].tolist() == want


def test_path_argument_on_cpu_tensors():
    """On CPU tensors both paths run the plain version; no launch is
    counted, and an unknown path raises."""
    plan = _plan()
    ins = _inputs(plan, 4)
    before = (WK.launches, dict(WK.launches_by_path))
    got = WK.windowed(plan, ins)
    assert torch.equal(WK.windowed(plan, ins, path="general"), got)
    assert (WK.launches, WK.launches_by_path) == before
    with pytest.raises(ValueError, match="path"):
        WK.windowed(plan, ins, path="igemm")


def test_a_remainder_over_n_reads_the_filters_columns():
    """Under h100 the ragged int8 conv's last unit covers filters 32..47 of
    40: the filter's k coordinate is checked, and a constraint masks, over
    N alone, so the view takes it and B reads 8 columns, zeros past
    them."""
    fns = _windowed_fns(_compiled("ragged_int8", "h100", True))
    views = [WK.conv_view(fn.plan) for fn in fns]
    assert all(v is not None for v in views)
    assert sorted((v.N, v.nb) for v in views) == [(16, 8), (32, 32)]


def test_params_carry_the_view():
    """The igemm launch record holds the view (the card reads it as
    IgParams); the general loop's parameters are the plan's."""
    fn = _windowed_fns(_compiled("resnet_b1_bfloat16", "h100", True))[0]
    plan, view = fn.plan, WK.conv_view(fn.plan)
    p = WK._ig_params(plan, view, fn.out_clip)
    assert (p.M, p.N, p.nb, p.K, p.kc) == (view.M, view.N, view.nb, view.K, view.kc)
    assert (p.bkmaj, p.bpack, p.mma, p.bsk, p.bsn) == (0, 0, 1, 64, 1)
    assert (p.splits, p.ksplit, p.nlim, p.out_sn, p.b_src_sn) == (view.splits, view.k_split,
                                                                    64, 1, 1)
    assert p.parts == 0 and view.work("bfloat16")[0] == view.splits * view.M * 64 * 4
    g = WK._params(plan, fn.out_clip)
    assert g.n_slot == 2 and g.n_chk == len(plan.checked()) and g.fast == 1


def test_tap_order_is_the_filters():
    """K runs c fastest, then the taps by the filter's strides: j before i
    for F[i, j, c, k], so the filter is one [576, 64] matrix."""
    fn = _windowed_fns(_compiled("resnet_b1_int8", "h100", True))[0]
    view = WK.conv_view(fn.plan)
    q = WK._tracked(fn.plan)[1]
    steps = [q[2][0]] + [q[2][t] for t in view.taps]
    assert steps == [64, 64 * 64, 3 * 64 * 64]
    for kf in itertools.islice(range(view.K), 0, view.K, 37):
        t, c = divmod(kf, view.kc)
        j, i = t % 3, t // 3
        assert c * steps[0] + j * steps[1] + i * steps[2] == kf * 64
