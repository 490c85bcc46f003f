"""The elementwise kernel's vec path on the CPU.

* which plans :func:`elementwise.vec_view` takes (the 4 unfused units of
  the exploration corpus) and why it refuses the others;
* the binding's stack slots against a stack simulation of every postfix
  program the compiler emits;
* a torch emulation of the vec kernel's algorithm, driven by the launch
  record the binding builds (its magic-number divmods, strides, packed
  instructions and slots): the thread-steps cover every point once, and
  the slot-register evaluator over 8-point vectors equals
  :func:`elementwise_plain`;
* the 4 units at reduced extents through the port's ``cuda`` backend
  against the JAX package's Pallas elementwise kernel in interpret mode.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cache as j_cache  # noqa: E402
from repro.core import lower_pallas as LP  # noqa: E402
from repro.core.driver import stripe_jit as j_jit  # noqa: E402
from repro.core.frontend import TileProgram as JTile  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402

from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import lower_cuda as LC  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram as TTile  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.core.lower_torch import _J_BINARY, _J_UNARY, torch_dtype  # noqa: E402
from repro_torch.explore.workloads import get_workloads  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402
from repro_torch.kernels import elementwise as EW  # noqa: E402

from test_torch_core_parity import _inputs  # noqa: E402
from test_torch_lower import PROGRAMS, _opt_blocks, _torch  # noqa: E402

# the 4 unfused units: (program, unit) -> (extents, each input's strides, program)
CORPUS_UNITS = {
    ("mm_bias_gelu", "bias_gelu"): ((1024, 512), ((1, 1024), (1, 0)), "bfloat16"),
    ("ffn_relu2", "bias"): ((1024, 512), ((1, 1024), (1, 0)), "float32"),
    ("ffn_relu2", "relu2"): ((1024, 512), ((1, 1024),), "float32"),
    ("moe_ffn", "gate"): ((1024, 256), ((1, 1024), (1, 1024)), "float32"),
}


def _compile(tp_or_prog, hw="h100"):
    prog = tp_or_prog.build() if hasattr(tp_or_prog, "build") else tp_or_prog
    hwc = t_hw(hw) if isinstance(hw, str) else hw
    return t_jit(prog, hwc, "cuda", cache=t_cache.CompilationCache(use_disk=False),
                 use_disk=False)


def _elementwise_fns(c):
    return {unit.name: fn for unit, _kind, fns in c._fn.steps for fn in fns
            if fn.kernel == "elementwise"}


def _zeros(c, fn):
    bufs = c.program.buffers
    return [torch.zeros(bufs[s.buf].shape, dtype=torch_dtype(str(bufs[s.buf].dtype)))
            for s in fn.plan.ins]


# ------------------------------------------------------------------ the view
@pytest.mark.parametrize("prog_name,unit", sorted(CORPUS_UNITS))
def test_corpus_units_take_vec(prog_name, unit):
    """Each unfused activation, bias or gate unit of the corpus under
    ``h100`` without fusion: two variables, variable 0 contiguous in the
    output and in every input or broadcast, a program at most 2 deep."""
    w = {w.name: w for w in get_workloads("all")}[prog_name]
    c = _compile(w.build(), t_hw("h100").without_pass("fuse"))
    fn = _elementwise_fns(c)[unit]
    ext, strides, out_dtype = CORPUS_UNITS[(prog_name, unit)]
    plan = fn.plan
    assert plan.out_ext == ext and plan.out_dtype == out_dtype
    assert tuple(s.ostride for s in plan.ins) == strides
    assert K.stack_depth(plan.prog) <= 2
    ins = _zeros(c, fn)
    view = EW.vec_view(plan, ins, fn.out_clip)
    assert view is not None, EW.refusal(plan, ins, fn.out_clip)
    assert view.n_vec * EW.VW == math.prod(ext) and not view.clipped


def _map_plan(tin="float32", tout="float32", shape=(16, 48), op=None):
    tp = TTile("map")
    m, n = shape
    tp.input("X", (m, n), tin); tp.input("b", (n,), tin); tp.input("Y", (m, n), tin)
    tp.output("O", (m, n), tout)
    act = "relu" if tin.startswith("int") else "silu"
    tp.op(op or f"O[i, j] = {act}(X[i, j] + b[j]) * Y[i, j]", name="map")
    c = _compile(tp)
    return c, _elementwise_fns(c)["map"]


def _ragged():
    tp = TTile("bcast")
    tp.input("X", (4, 33, 70), "bfloat16"); tp.input("b", (70,)); tp.input("s", (33, 1))
    tp.output("O", (4, 33, 70), "bfloat16")
    tp.op("O[n, i, j] = silu(X[n, i, j] + b[j]) * s[i, 0]", name="map")
    c = _compile(tp)
    fn = _elementwise_fns(c)["map"]
    return fn.plan, None, fn.out_clip


def _transposed():
    """X read as X[j, i] from a (48, 16) buffer (the compiler sends such a
    map to the windowed kernel; here the plan is built by hand)."""
    _c, fn = _map_plan()
    plan = fn.plan
    ins = (dataclasses.replace(plan.ins[0], ostride=(16, 1)),) + plan.ins[1:]
    return dataclasses.replace(plan, ins=ins, _cparams={}), None, fn.out_clip


def _base_offset():
    _c, fn = _map_plan()
    plan = fn.plan
    ins = (dataclasses.replace(plan.ins[0], base=3),) + plan.ins[1:]
    return dataclasses.replace(plan, ins=ins, _cparams={}), None, fn.out_clip


def _deep():
    tp = TTile("deep")
    for name in "ABCDE":
        tp.input(name, (16, 48))
    tp.output("O", (16, 48))
    tp.op("O[i, j] = A[i, j] + B[i, j] * (C[i, j] - (D[i, j] + E[i, j]))", name="map")
    fn = _elementwise_fns(_compile(tp))["map"]
    return fn.plan, None, fn.out_clip


def _misaligned():
    c, fn = _map_plan()
    ins = _zeros(c, fn)
    ins[0] = torch.zeros(16 * 48 + 1)[1:].view(16, 48)
    return fn.plan, ins, fn.out_clip


def _line(ext=104, clip=100):
    plan = EW.MapPlan(out_vars=("j",), out_ext=(ext,), out_dim=(0,), out_coef=(1,),
                      out_shape=(ext,), ins=(K.Slot("X", 0, (1,), ()),),
                      prog=((K.OP_LOAD, 0), (K.OP_UNARY + K.UNARY_OPS.index("relu"), 0)),
                      consts=())
    return plan, None, (clip,)


@pytest.mark.parametrize("case,reason", [
    (_ragged, "has extent 70, not a multiple of 8"),
    (_transposed, "input X has stride 16 along variable 0"),
    (_base_offset, "input X starts at element 3, not a multiple of 8"),
    (_deep, "the program is 5 deep, past the 4 slots in registers"),
    (_misaligned, "input X does not start on a 16-byte boundary"),
    (_line, "the clip (100,) cuts a vector along output dimension 0"),
], ids=["ragged", "transposed", "base", "deep", "misaligned", "clip"])
def test_refused_plans_name_their_reason(case, reason):
    plan, ins, clip = case()
    assert EW.vec_view(plan, ins, clip) is None
    assert reason in EW.refusal(plan, ins, clip)


def _row_scale(rows=13):
    """A per-row scale ``s[i, 0]``: broadcast along variable 0 (strides (0,
    1)), its stride along the rows not a multiple of 8."""
    tp = TTile("row_scale")
    tp.input("X", (rows, 48)); tp.input("s", (rows, 1))
    tp.output("O", (rows, 48))
    tp.op("O[i, j] = relu(X[i, j]) * s[i, 0]", name="map")
    c = _compile(tp)
    return c, _elementwise_fns(c)["map"]


def test_a_broadcast_input_takes_vec_unaligned():
    """A broadcast input is read one scalar a vector: its base, its strides
    and its alignment do not matter, so a per-row scale from a misaligned
    slice takes vec, and the emulation matches plain."""
    c, fn = _row_scale()
    plan = fn.plan
    assert [s.ostride for s in plan.ins] == [(1, 48), (0, 1)]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(13, 48, generator=gen)
    s = torch.randn(14, generator=gen)[1:].view(13, 1)
    assert s.data_ptr() % 16
    ins = [x, s] if plan.ins[0].buf == "X" else [s, x]
    view = EW.vec_view(plan, ins, fn.out_clip)
    assert view is not None, EW.refusal(plan, ins, fn.out_clip)
    assert EW.input_alignment(ins) != (True, True)
    based = dataclasses.replace(plan, ins=(plan.ins[0], dataclasses.replace(plan.ins[1], base=3)),
                                _cparams={})
    assert EW.vec_view(based, None, fn.out_clip) is not None, EW.refusal(based)
    got = _emulate(plan, ins, fn.out_clip)
    assert torch.equal(got, EW.elementwise_plain(plan, ins, fn.out_clip))


def test_magic_division_matches_floor_division():
    rng = np.random.RandomState(0)
    divisors = [1, 2, 3, 7, 8, 56, 64, 70, 128, 1000, 4097, 65535, 2**20 + 1, 2**31 - 1]
    divisors += list(rng.randint(1, 2**31 - 1, size=40))
    n = np.concatenate([np.arange(0, 4096), rng.randint(0, 2**31, size=4096),
                        [2**31 - 1, 2**31 - 2, 2**30]]).astype(object)
    for d in divisors:
        mul, shr = EW.magic(int(d))
        assert 0 < mul < 2**32
        for x in n:
            assert (int(x) * mul) >> shr == int(x) // int(d), (x, d)


# ------------------------------------------------------------ the stack slots
def _simulated_slots(prog):
    """A stack of the instructions that pushed each live value: an
    operand's slot is its depth in that stack."""
    stack, out = [], []
    for i, (code, _arg) in enumerate(prog):
        if code in (K.OP_LOAD, K.OP_CONST, K.OP_ACC):
            stack.append(i)
            out.append((len(stack) - 1, -1, -1))
        elif code < K.OP_BINARY:
            out.append((stack.index(stack[-1]), len(stack) - 1, -1))
            stack[-1] = i
        else:
            a, b = len(stack) - 2, len(stack) - 1
            stack[-2:] = [i]
            out.append((stack.index(i), a, b))
    assert len(stack) == 1 and out[-1][0] == 0
    return tuple(out)


def _extracted_programs(name):
    """Every postfix program of a test program's units: the contraction
    prologues and epilogues (as in test_postfix_programs_of_extracted_plans)
    and the maps."""
    _jb, tbuild = PROGRAMS[name]
    progs = []
    for _jblk, tb in _opt_blocks("tpu_v5e", _jb(), tbuild()):
        try:
            plan = LC.extract_contraction(LC._ensure_grid(tb))
        except LC.UnsupportedCuda:
            continue
        pf = LC._Postfix()
        for side in (plan.lhs, plan.rhs):
            names = sorted({ld.buf for ld in side.loads()})
            progs.append(tuple(pf.tnode(side, {n: i for i, n in enumerate(names)})))
        if plan.epilogue:
            from repro_torch.core.ir import Load
            names = sorted({s.buf for s in plan.epilogue
                            if isinstance(s, Load) and s.into != plan.acc_scalar})
            progs.append(tuple(pf.epilogue(plan.epilogue, plan.acc_scalar,
                                           {n: i for i, n in enumerate(names)})))
    for _unit, _kind, fns in _compile(tbuild(), "tpu_v5e")._fn.steps:
        progs += [fn.plan.prog for fn in fns if fn.kernel == "elementwise"]
    return progs


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_prog_slots_match_a_stack_simulation(name):
    progs = _extracted_programs(name)
    assert progs
    for prog in progs:
        slots = EW.prog_slots(prog)
        assert slots == _simulated_slots(prog), prog
        assert max(d for d, _a, _b in slots) == K.stack_depth(prog) - 1


def test_prog_slots_of_the_all_ops_dag():
    from test_torch_lower import _all_ops_dag

    prog = tuple(LC._Postfix().tnode(_all_ops_dag(), {"X": 0, "Y": 1}))
    assert EW.prog_slots(prog) == _simulated_slots(prog)


# ------------------------------------------------- the vec kernel, emulated
def _emulate(plan, ins, clip, n_blocks=3, block=32):
    """The vec kernel's algorithm in torch, read from the launch record:
    grid-stride thread-steps of one vector, the row by magic-number
    divmods, 8-lane loads (one scalar where broadcast), the program over
    slot registers by its packed words, one rounding at the store."""
    view = EW.vec_view(plan, ins, clip)
    assert view is not None, EW.refusal(plan, ins, clip)
    p = EW._vec_params(plan, view, clip)
    threads = n_blocks * block
    steps = [q for t in range(threads) for q in range(t, p.n_vec, threads)]
    assert sorted(steps) == list(range(p.n_vec)), "every vector exactly once"
    q = torch.tensor(steps, dtype=torch.int64)
    rest, v = q, []
    for i in range(p.n_var):
        nxt = (rest * p.div_mul[i]) >> p.div_shr[i]
        v.append((rest - nxt * p.div[i]) * (EW.VW if i == 0 else 1))
        rest = nxt
    oo = sum(p.out_stride[i] * v[i] for i in range(p.n_var))
    inside = torch.ones_like(q, dtype=torch.bool)
    if p.clipped:
        for d in range(p.out_rank):
            c = sum(p.clip_coef[d][i] * v[i] for i in range(p.n_var))
            inside &= c < p.out_clip[d]
    lanes = torch.arange(EW.VW)
    acc_t = torch_dtype(plan.acc)
    loads = []
    for s, t in enumerate(ins):
        off = p.in_base[s] + sum(p.in_stride[s][i] * v[i] for i in range(p.n_var))
        idx = off[:, None] + (0 * lanes if p.in_bcast[s] else lanes)
        loads.append(t.reshape(-1)[idx].to(acc_t))
    r = [None] * EW.VSLOT
    for i in range(p.n):
        w = p.ins[i]
        code, arg = w & 0xff, (w >> 8) & 0xff
        dst, a, b = (w >> 16) & 7, (w >> 20) & 7, (w >> 24) & 7
        if code == K.OP_LOAD:
            x = loads[arg]
        elif code == K.OP_CONST:
            x = torch.full_like(loads[0], p.consts[arg])
        elif code < K.OP_BINARY:
            x = _J_UNARY[K.UNARY_OPS[code - K.OP_UNARY]](r[a])
        else:
            x = _J_BINARY[K.BINARY_OPS[code - K.OP_BINARY]](r[a], r[b])
        r[dst] = x
    out = torch.zeros(math.prod(clip), dtype=torch_dtype(plan.out_dtype))
    points = (oo[inside][:, None] + lanes).reshape(-1)
    assert points.unique().numel() == points.numel(), "no point stored twice"
    if not p.clipped:
        assert points.numel() == out.numel(), "every point stored"
    out[points] = r[0][inside].reshape(-1).to(out.dtype)
    return out.reshape(clip)


def _emulation_cases():
    return {
        "f32": lambda: _map_plan(shape=(16, 48)),
        "f32_bf16": lambda: _map_plan("float32", "bfloat16", shape=(16, 48)),
        "bf16": lambda: _map_plan("bfloat16", "bfloat16", shape=(24, 64)),
        "f16": lambda: _map_plan("float16", "float16", shape=(8, 40)),
        "int8_int32": lambda: _map_plan("int8", "int32", shape=(16, 48)),
        "consts": lambda: _map_plan(op="O[i, j] = gelu(X[i, j] * 0.5 - b[j]) + Y[i, j] / 3.0"),
    }


def _close_one_step(got, want):
    """Within one rounding step of a 16-bit float (2**-7 of the element for
    bf16, 2**-10 for f16), plus 1e-6 of the largest output: the float32
    noise where the DAG cancels (gelu of a large negative input)."""
    g, w = got.float(), want.float()
    step = 2.0 ** (-7 if got.dtype == torch.bfloat16 else -10)
    assert torch.all((g - w).abs() <= step * w.abs() + 1e-6 * w.abs().max()), \
        (g - w).abs().max()


def _hold(got, want, prog):
    """The emulation against plain: the same ops in the same order, so
    integers and float32 agree exactly, but for gelu, whose CPU kernel
    rounds the last bit differently on torch's vectorized and scalar loops
    (held to 1e-6 of the largest output); 16-bit outputs within one
    rounding step."""
    assert got.dtype == want.dtype and got.shape == want.shape
    gelu = K.OP_UNARY + K.UNARY_OPS.index("gelu")
    if want.dtype in (torch.bfloat16, torch.float16):
        _close_one_step(got, want)
    elif want.dtype == torch.float32 and any(code == gelu for code, _ in prog):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(_emulation_cases()))
def test_vec_emulation_matches_plain(case):
    c, fn = _emulation_cases()[case]()
    arrays = _inputs(c.program.source, seed=11)
    ins = [_torch(arrays[s.buf]) for s in fn.plan.ins]
    got = _emulate(fn.plan, ins, fn.out_clip)
    _hold(got, EW.elementwise_plain(fn.plan, ins, fn.out_clip), fn.plan.prog)


@pytest.mark.parametrize("prog_name,unit", sorted(CORPUS_UNITS))
def test_vec_emulation_of_the_corpus_units(prog_name, unit):
    """The 4 units at full size, random inputs of their types."""
    w = {w.name: w for w in get_workloads("all")}[prog_name]
    c = _compile(w.build(), t_hw("h100").without_pass("fuse"))
    fn = _elementwise_fns(c)[unit]
    gen = torch.Generator().manual_seed(5)
    ins = [torch.randn(t.shape, generator=gen).to(t.dtype) for t in _zeros(c, fn)]
    got = _emulate(fn.plan, ins, fn.out_clip, n_blocks=7, block=64)
    _hold(got, EW.elementwise_plain(fn.plan, ins, fn.out_clip), fn.plan.prog)


def test_vec_emulation_with_a_clip():
    """A clip of whole vectors: the kernel tests each vector and stores
    only those inside."""
    plan, _ins, _clip = _line(ext=104)
    x = torch.randn(104)
    got = _emulate(plan, [x], (96,))
    assert torch.equal(got, EW.elementwise_plain(plan, [x], (96,)))
    assert EW.vec_view(plan, [x], (96,)).clipped
    assert not EW.vec_view(plan, [x], (104,)).clipped


# ------------------------------------------- the JAX package's Pallas kernel
# the 4 units' functions at reduced extents (48 rows of 64)
UNIT_OPS = {
    "bias_gelu": ("O[i, j] = gelu(T[i, j] + B[j])", {"T": (48, 64), "B": (64,)}, "bfloat16"),
    "bias": ("O[i, j] = T[i, j] + b[j]", {"T": (48, 64), "b": (64,)}, "float32"),
    "relu2": ("O[i, j] = square(relu(U[i, j]))", {"U": (48, 64)}, "float32"),
    "gate": ("O[i, j] = silu(H[i, j]) * U[i, j]", {"H": (48, 64), "U": (48, 64)}, "float32"),
}


def _unit_program(tp_cls, name):
    op, ins, out_dtype = UNIT_OPS[name]
    tp = tp_cls(name)
    for buf, shape in ins.items():
        tp.input(buf, shape, "float32")
    tp.output("O", (48, 64), out_dtype)
    tp.op(op, name=name)
    return tp.build()


@pytest.mark.parametrize("name", sorted(UNIT_OPS))
def test_units_match_the_pallas_elementwise_kernel(name, monkeypatch):
    used = []
    orig = LP._emit_elementwise

    def spy(plan, *a, **kw):
        used.append(plan.out_ref.ref.from_buf)
        return orig(plan, *a, **kw)

    monkeypatch.setattr(LP, "_emit_elementwise", spy)
    jprog, tprog = _unit_program(JTile, name), _unit_program(TTile, name)
    jc = j_jit(jprog, j_hw("tpu_v5e"), "pallas", interpret=True,
               cache=j_cache.CompilationCache(use_disk=False), use_disk=False)
    tc = _compile(tprog, "tpu_v5e")
    assert used == ["O"], "the reference lowered the unit through its elementwise kernel"
    (fn,) = _elementwise_fns(tc).values()
    arrays = _inputs(jprog, seed=12)
    ins = [_torch(arrays[s.buf]) for s in fn.plan.ins]
    assert EW.vec_view(fn.plan, ins, fn.out_clip) is not None, EW.refusal(fn.plan, ins)
    want = jc({k: jnp.asarray(v) for k, v in arrays.items()})["O"]
    got = tc({k: _torch(v) for k, v in arrays.items()})["O"]
    w = torch.from_numpy(np.array(want, dtype=np.float32))
    if UNIT_OPS[name][2] == "bfloat16":
        assert got.dtype == torch.bfloat16
        _close_one_step(got, w.to(torch.bfloat16))
    else:
        err = (got - w).abs().max().item()
        assert err <= 1e-6 * w.abs().max().item(), err
