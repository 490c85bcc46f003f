"""The port's op library and dense model against the JAX package's, on the CPU.

* ``oplib.linear``: the same Tile program compiles under the reference's
  own ``tpu_v5e`` to the same optimized IR (``ir_fingerprint``) and the
  same units; the port's ``torch`` backend is held against the
  reference's ``jnp`` and its ``cuda`` backend (every unit on the
  contraction kernel, run as its plain version on CPU tensors) against
  the reference's Pallas kernel in interpret mode (the twin of
  ``tests/test_kernels.py::test_oplib_backends_agree``), with bias and
  activations, in float32 and bfloat16.  Tolerances against the largest
  reference output: float32 within 1e-4 (sums of up to 128 float32 terms
  in other orders); bfloat16 within 1e-2 of the element plus 1e-3 of the
  largest value (both sides round float32 sums to bf16, whose spacing is
  2**-8 = 3.9e-3 of the value).
* The dense model (llama3-8b's family, 2 layers, narrow) with the
  reference's weights (``params_from_jax``): ``loss``, ``prefill`` and
  ``decode_step`` under both backends against the reference's ``jnp``
  backend — float32 within 1e-4 of the largest logit (and of the loss),
  bfloat16 logits within 5e-2 of the largest (the serve phase's logit
  tolerance: bf16 re-rounds the residual stream in every layer) — and the
  KV caches they return; prefill then decode equal to the full forward
  (``tests/test_arch_smoke.py``'s identity, rtol and atol 2e-3).
* ``make_batch`` draws the reference's tokens, ``input_specs`` its shapes
  and dtypes, ``init_cache`` its cache layout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.core import oplib as j_oplib  # noqa: E402
from repro.core.ir import ir_fingerprint as j_fp  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import input_specs as j_specs  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs.base import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.core.ir import ir_fingerprint as t_fp  # noqa: E402
from repro_torch.models.build import input_specs as t_specs  # noqa: E402

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
            head_dim=16, vocab_pad_multiple=16)
TWIN = {"torch": "jnp", "cuda": "pallas_interpret"}


@pytest.fixture
def backends():
    """Restore both packages' oplib backends after a test."""
    old = (j_oplib.get_backend(), t_oplib.get_backend())
    yield
    j_oplib.set_backend(old[0])
    t_oplib.set_backend(old[1])


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _assert_close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    if dtype == "bfloat16":
        bound = 1e-2 * np.abs(want) + 1e-3 * scale
    else:
        bound = 1e-4 * (1.0 + scale)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"{what}: max error {err.max():.3e} (scale {scale:.3e})"


# ------------------------------------------------------------------ oplib
LINEAR_CASES = [(None, False), ("relu", True), ("silu", False), ("gelu", True)]


def _linear_inputs(dtype, seed=5, m=64, k=128, n=96):
    rng = np.random.RandomState(seed)
    x, w, b = rng.randn(m, k), rng.randn(k, n) * 0.1, rng.randn(n)
    jx, jw = (jnp.asarray(a, jnp.dtype(dtype)) for a in (x, w))
    jb = jnp.asarray(b, jnp.float32)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # the same (rounded) values: bf16 -> float32 -> bf16 is exact
    tx, tw = (torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(tdtype)
              for a in (jx, jw))
    tb = torch.tensor(np.asarray(jb))
    return (jx, jw, jb), (tx, tw, tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", LINEAR_CASES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_oplib_linear_matches_reference(backend, act, bias, dtype, backends):
    (jx, jw, jb), (tx, tw, tb) = _linear_inputs(dtype)
    j_oplib.set_backend(TWIN[backend])
    t_oplib.set_backend(backend)
    want = j_oplib.linear(jx, jw, jb if bias else None, act=act)
    got = t_oplib.linear(tx, tw, tb if bias else None, act=act)
    # as in the reference, a bf16 input with a float32 bias gives float32
    # on the einsum path and bf16 (the program's output type) on the kernel
    assert str(got.dtype) == f"torch.{want.dtype}"
    _assert_close(got, want, dtype, f"{backend} {act} bias={bias}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias", LINEAR_CASES)
def test_oplib_compiles_the_reference_program_and_units(act, bias, dtype):
    """Under ``tpu_v5e`` both packages compile the same optimized program;
    every unit the reference's strict Pallas lowering takes lowers to the
    port's contraction kernel."""
    args = (64, 128, 96, dtype, "float32", act, bias)
    j_op = j_oplib._compiled_linear(*args, "pallas_interpret")
    t_op = t_oplib._compiled_linear(*args, "cuda")
    assert t_fp(t_op.optimized) == j_fp(j_op.optimized)
    assert j_op.pallas_ok
    assert t_op.block_backends and set(t_op.block_backends.values()) == {"cuda"}, \
        t_op.block_reasons
    for _u, kind, kernels in t_op.cuda_fn.steps:
        assert kind == "cuda" and [fn.kernel for fn in kernels] == ["contraction"]


# rows the tile does not divide (the wave's prefills: 4 x 100 and 4 x 356
# rows), in bf16, where tpu_v5e nests the tiles
RAGGED = [(400, 1024, 2048, None, "bfloat16"), (400, 1024, 2048, "silu", "bfloat16"),
          (1424, 512, 1024, None, "bfloat16")]


@pytest.mark.parametrize("m,k,n,act,dtype", RAGGED)
def test_oplib_ragged_rows_run_as_one_launch(m, k, n, act, dtype, backends):
    """The boundary pass splits the rows into an interior piece and a
    ragged edge whose constraint keeps the rows inside the buffer.  The
    reference's Pallas backend refuses the unit (the windowed path takes
    no nested tile: ``pallas_ok`` false, jnp runs it); the port lowers the
    edge as the contraction over the rows that exist and joins the two
    pieces into one launch over all m rows, held against the reference's
    jnp backend as the other oplib cases are."""
    from repro_torch.core.ir import Block

    args = (m, k, n, dtype, "float32", act, False)
    assert not j_oplib._compiled_linear(*args, "pallas_interpret").pallas_ok
    op = t_oplib._compiled_linear(*args, "cuda")
    pieces = [b for b in op.optimized.entry.stmts if isinstance(b, Block)]
    assert len(pieces) == 2 and any("boundary" in b.tags for b in pieces)
    assert set(op.block_backends.values()) == {"cuda"} and not op.block_reasons
    ((_unit, kind, (fn,)),) = op.cuda_fn.steps
    assert kind == "cuda" and fn.out_base == (0, 0) and fn.out_shape == (m, n)
    (jx, jw, _jb), (tx, tw, _tb) = _linear_inputs(dtype, m=m, k=k, n=n)
    j_oplib.set_backend("jnp")
    t_oplib.set_backend("cuda")
    _assert_close(t_oplib.linear(tx, tw, act=act), j_oplib.linear(jx, jw, act=act), dtype,
                  f"ragged {m} rows")


def test_c4_fused_group_with_ragged_rows_lowers_to_one_launch():
    """ROADMAP C4's unit, ``O = gelu(0.5 * A @ B + b) + R`` at (130, 150,
    260) under h100: the ragged rows' edge piece now lowers (it fell back
    to torch), joined with the interior into one launch, equal to the
    torch backend."""
    from repro_torch.core import cache as t_cache
    from repro_torch.core.frontend import TileProgram

    m, n, k = 130, 150, 260
    tp = TileProgram("c4")
    tp.input("A", (m, k)); tp.input("B", (k, n)); tp.input("b", (n,)); tp.input("R", (m, n))
    tp.temp("T", (m, n)); tp.output("O", (m, n))
    tp.op("T[i, j] += 0.5 * A[i, c] * B[c, j]", name="mm")
    tp.op("O[i, j] = gelu(T[i, j] + b[j]) + R[i, j]", name="epi")
    prog = tp.build()
    c, r = (api.jit(prog, api.get_config("h100"), be, use_disk=False,
                    cache=t_cache.CompilationCache(use_disk=False)) for be in ("cuda", "torch"))
    assert c.record.block_backends == {"mm+epi": "cuda"} and not c.record.fallback_reasons()
    assert c.record.n_kernels == 1
    g = torch.Generator().manual_seed(0)
    arrays = {"A": torch.randn(m, k, generator=g), "B": torch.randn(k, n, generator=g),
              "b": torch.randn(n, generator=g), "R": torch.randn(m, n, generator=g)}
    _assert_close(c(arrays)["O"], r(arrays)["O"], "float32", "C4")


def test_oplib_set_backend_refuses_unknown_names(backends):
    with pytest.raises(ValueError):
        t_oplib.set_backend("pallas")
    t_oplib.set_backend("cuda")
    assert t_oplib.get_backend() == api.get_backend() == "cuda"


def test_nn_linear_reaches_oplib_only_off_the_torch_backend(backends, monkeypatch):
    from repro_torch.nn import core as t_core

    calls = []
    real = t_oplib.linear
    monkeypatch.setattr(t_oplib, "linear", lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w = torch.randn(2, 3, 8), torch.randn(8, 4)
    t_oplib.set_backend("torch")
    a = t_core.linear(x, w, act="silu")
    assert not calls
    t_oplib.set_backend("cuda")
    b = t_core.linear(x, w, act="silu")
    assert calls and a.shape == b.shape == (2, 3, 4)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model
def _models(dtype="float32"):
    jcfg = j_configs.get("llama3-8b").scaled(**TINY, dtype=dtype)
    tcfg = api.configs.get("llama3-8b").scaled(**TINY, dtype=dtype)
    jm, tm = j_build(jcfg), api.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


def _batch(cfg, kind, b, s, seed):
    jb = j_batch(cfg, kind, b, s, seed=seed)
    tb = api.make_batch(cfg, kind, b, s, seed=seed, device="cpu")
    return jb, tb


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loss_matches_reference(f32_models, backend, backends):
    jm, jp, tm, tp = f32_models
    jb, tb = _batch(tm.cfg, "train", 2, 16, seed=1)
    j_oplib.set_backend("jnp")
    t_oplib.set_backend(backend)
    jl, jmet = jm.loss(jp, jb, remat=False)
    tl, tmet = tm.loss(tp, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(f32_models, backend, backends):
    jm, jp, tm, tp = f32_models
    jb, tb = _batch(tm.cfg, "prefill", 2, 12, seed=3)
    j_oplib.set_backend("jnp")
    t_oplib.set_backend(backend)
    jl, jc = jm.prefill(jp, jb, jm.init_cache(2, 32))
    tl, tc = tm.prefill(tp, tb, tm.init_cache(2, 32, device="cpu"))
    _assert_close(tl, jl, "float32", "prefill logits")
    for k in ("k", "v", "pos"):
        _assert_close(tc[k], jc[k], "float32", f"prefill cache {k}")
    tok = np.array([[7], [11]], np.int32)
    for step in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok + step))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok + step))
        _assert_close(tl, jl, "float32", f"decode {step} logits")
        for k in ("k", "v", "pos"):
            _assert_close(tc[k], jc[k], "float32", f"decode {step} cache {k}")
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == (TINY["n_layers"],)
    assert int(tc["pos"][0]) == 12 + 3


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bf16_prefill_and_decode_logits_match_reference(backend, backends):
    jm, jp, tm, tp = _models("bfloat16")
    jb, tb = _batch(tm.cfg, "prefill", 2, 12, seed=3)
    j_oplib.set_backend("jnp")
    t_oplib.set_backend(backend)
    jl, jc = jm.prefill(jp, jb, jm.init_cache(2, 32))
    tl, tc = tm.prefill(tp, tb, tm.init_cache(2, 32, device="cpu"))
    assert tl.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
    tok = np.array([[7], [11]], np.int32)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(tok))
    td, _ = tm.decode_step(tp, tc, torch.from_numpy(tok))
    for what, got, want in (("prefill", tl, jl), ("decode", td, jd)):
        got, want = _np(got), _np(want)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 5e-2, f"{what}: {rel:.3e}"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_then_decode_matches_full_forward(f32_models, backend, backends):
    """Prefill s tokens then decode one more == prefill over s + 1 tokens."""
    _jm, _jp, tm, tp = f32_models
    t_oplib.set_backend(backend)
    b, s = 2, 12
    full = api.make_batch(tm.cfg, "prefill", b, s + 1, seed=3, device="cpu")
    logits_full, _ = tm.prefill(tp, full, tm.init_cache(b, 32, device="cpu"))
    part = {"tokens": full["tokens"][:, :s]}
    _, cache = tm.prefill(tp, part, tm.init_cache(b, 32, device="cpu"))
    logits_dec, _ = tm.decode_step(tp, cache, full["tokens"][:, s: s + 1])
    np.testing.assert_allclose(_np(logits_dec[:, -1]), _np(logits_full[:, -1]),
                               rtol=2e-3, atol=2e-3)


def test_prefill_and_decode_write_the_donated_cache_in_place(f32_models):
    """The cache is donated: the KV rows go into the stacked ``k``/``v``
    buffers passed in, which come back (no copy of the whole cache a
    step), beside a new ``pos``; the rows past ``pos`` stay zero."""
    _jm, _jp, tm, tp = f32_models
    cache = tm.init_cache(2, 32, device="cpu")
    ks, vs, pos0 = cache["k"], cache["v"], cache["pos"].clone()
    batch = api.make_batch(tm.cfg, "prefill", 2, 5, seed=0, device="cpu")
    _, new = tm.prefill(tp, batch, cache)
    assert new["k"] is ks and new["v"] is vs
    assert torch.equal(cache["pos"], pos0)
    assert new["pos"].tolist() == [5] * tm.cfg.n_layers
    assert ks[:, :, :5].abs().sum() > 0 and not ks[:, :, 5:].any() and not vs[:, :, 5:].any()
    _, new2 = tm.decode_step(tp, new, batch["tokens"][:, :1])
    assert new2["k"] is ks and new2["pos"].tolist() == [6] * tm.cfg.n_layers
    assert ks[:, :, 5].abs().sum() > 0 and not ks[:, :, 6:].any()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_draws_the_reference_tokens(kind):
    cfg = api.configs.get("llama3-8b").scaled(**TINY)
    jb, tb = _batch(cfg, kind, 3, 10, seed=7)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
def test_input_specs_match_reference(shape):
    cfg = api.configs.get("llama3-8b")
    jspec = j_specs(j_configs.get("llama3-8b"), J_SHAPES[shape])
    tspec = t_specs(cfg, T_SHAPES[shape])
    assert sorted(tspec) == sorted(jspec)
    for k, v in jspec.items():
        assert tuple(tspec[k].shape) == tuple(v.shape)
        assert str(tspec[k].dtype) == f"torch.{v.dtype}"
        assert tspec[k].device.type == "meta"


def test_init_cache_matches_reference_layout():
    cfg = api.configs.get("llama3-8b").scaled(**TINY)
    jc = j_build(j_configs.get("llama3-8b").scaled(**TINY)).init_cache(3, 24)
    tc = api.build_model(cfg).init_cache(3, 24, device="cpu")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        assert str(tc[k].dtype) == f"torch.{jc[k].dtype}"
        assert not tc[k].any()


def test_other_families_refuse_and_cite_the_roadmap():
    """Every family of the registry builds now; a config whose family has
    no model (an ssm config without ``xlstm``) is refused with the
    reference's error."""
    import dataclasses

    cfg = dataclasses.replace(api.configs.get("llama3-8b"), family="ssm")
    jcfg = dataclasses.replace(j_configs.get("llama3-8b"), family="ssm")
    for build, c in ((api.build_model, cfg), (j_build, jcfg)):
        with pytest.raises(ValueError, match="no model for family ssm"):
            build(c)
