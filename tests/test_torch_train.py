"""The port's training slice (A8c) against the JAX package's, on the CPU:
the tree helper, AdamW, int8 compression, the data pipeline, checkpoints,
one train step of every registry config, the ``Trainer``, and the kernels'
refusal of autograd (ROADMAP C11).

Tolerances, each against the reference on the same seeded numpy inputs:

* ``lr_at``: rtol 1e-6.
* AdamW: ``grad_norm`` within 1e-6 relative, new ``m`` and ``v`` within
  1e-6 of the leaf's largest (float32 arithmetic in both; the norm sums
  in another order, so the clip scale may differ in its last bit, and
  ``b1 m + (1 - b1) g`` cancels at the second step); new
  parameters within 1e-6 relative where ``|g| > 1e-6 max|g|`` (Adam's
  first step is ``sign(g)``: a near-zero gradient whose sign differs
  moves its parameter by ``2 lr``), and one bf16 rounding step (2**-7
  relative) for bf16 parameters.  The in-place update equals the
  functional one bit for bit.
* compression and the data pipeline: bit-exact.
* checkpoints: every leaf exact, the ``.npz`` arrays byte-equal.
* a train step: the loss within ``STEP_LOSS_RTOL`` (1e-5) relative and
  each gradient leaf within ``STEP_GRAD_RTOL`` (1e-4) x (1 + the leaf's
  largest |g|), float32 (``scaled()``); ``remat=True`` equals
  ``remat=False`` in the port within the same tolerances.
* the ``Trainer``: 12 losses within ``TRAINER_RTOL`` (1e-4) relative of
  the reference's from the same initial weights; a resumed run within
  rtol 1e-6 of the uninterrupted one (the reference test's own).
"""
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import oplib as j_oplib  # noqa: E402
from repro.core.cache import CompilationCache as JCache  # noqa: E402
from repro.core.driver import stripe_jit as j_stripe_jit  # noqa: E402
from repro.core.frontend import single_op_program as j_single_op  # noqa: E402
from repro.core.hwconfig import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention as j_flash  # noqa: E402
from repro.kernels.mlstm_chunk.kernel import chunked_gla as j_gla  # noqa: E402
from repro.kernels.mlstm_chunk.kernel import mlstm_chunk as j_mlstm  # noqa: E402
from repro.kernels.ssd_chunk.kernel import ssd_chunk as j_ssd  # noqa: E402
from repro.kernels.stripe_matmul.ops import matmul as j_matmul  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import compress as j_compress  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.core.cache import CompilationCache as TCache  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_stripe_jit  # noqa: E402
from repro_torch.core.frontend import single_op_program as t_single_op  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_get_config  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels._build import KernelAutogradError  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import chunked_gla as t_gla  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk as t_mlstm  # noqa: E402
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk as t_ssd  # noqa: E402
from repro_torch.kernels.stripe_matmul.ops import matmul as t_matmul  # noqa: E402
from repro_torch.models.build import build_model as t_build  # noqa: E402
from repro_torch.models.build import make_batch as t_batch  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compress as t_compress  # noqa: E402
from repro_torch.reliability import faults as t_faults  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402

ARCHS = j_configs.names()
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4
TRAINER_RTOL = 1e-4


@pytest.fixture
def backends():
    old = (j_oplib.get_backend(), t_oplib.get_backend())
    yield
    j_oplib.set_backend(old[0])
    t_oplib.set_backend(old[1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tiny(pkg_configs):
    """The reference test's tiny llama3-8b (``tests/test_train_fault.py``)."""
    return pkg_configs.get("llama3-8b").scaled(n_layers=2, d_model=32, n_heads=2,
                                               n_kv_heads=2, d_ff=64, vocab=64,
                                               head_dim=16, vocab_pad_multiple=16)


# ------------------------------------------------------------------ tree
def test_tree_flattens_in_jax_leaf_order():
    tree = {"b": [np.float32(1), {"z": np.arange(2), "a": np.ones(3)}],
            "a": (np.zeros(1), None), "c": {}, "blocks": {"wq": np.eye(2)}}
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got, treedef = T.flatten_with_path(tree)
    assert [T.key_path(p) for p, _ in got] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp) for kp, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a is b
    back = T.unflatten(treedef, [leaf for _, leaf in got])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    doubled = T.tree_map(lambda a: a + a, tree)
    np.testing.assert_array_equal(doubled["b"][1]["a"], 2 * np.ones(3))
    assert doubled["a"][1] is None and doubled["c"] == {}
    with pytest.raises(ValueError, match="more leaves"):
        T.unflatten(treedef, [leaf for _, leaf in got] + [0])


# ----------------------------------------------------------------- AdamW
def test_lr_at_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=7, total_steps=40, min_lr_frac=0.1)
    jc, tc = j_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    for s in range(0, tc.total_steps + 6):
        want = float(j_adamw.lr_at(jc, jnp.asarray(s, jnp.int32)))
        got = float(t_adamw.lr_at(tc, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"step {s}")


def _adam_tree(dtype, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"blocks": {"w": (3, 8, 16), "b": (3, 16)}, "embed": (32, 8), "norm": (8,)}
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple)) for _ in range(2)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = T.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    return jp, tp, grads, jdt, tdt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_apply_updates_match_reference(dtype):
    """Two AdamW steps on a seeded tree (a clipped and an unclipped
    gradient), the parameters in ``dtype``."""
    jp, tp, grads, jdt, tdt = _adam_tree(dtype)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=50.0)
    jc, tc = j_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    js, ts = j_adamw.init_state(jp), t_adamw.init_state(tp)
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = T.tree_map(lambda a: torch.from_numpy(a).to(tdt), g)
        np.testing.assert_allclose(float(t_adamw.global_norm(tg)),
                                   float(j_adamw.global_norm(jg)), rtol=1e-6)
        jp, js, jinfo = j_adamw.apply_updates(jp, jg, js, jc)
        tp, ts, tinfo = t_adamw.apply_updates(tp, tg, ts, tc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        for name in ("m", "v"):
            for a, b in zip(T.leaves(ts[name]), jax.tree.leaves(js[name])):
                assert a.dtype == torch.float32
                b = _np(b)
                np.testing.assert_allclose(_np(a), b, rtol=0, atol=1e-6 * np.abs(b).max())
        p_rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
        for a, b, gl in zip(T.leaves(tp), jax.tree.leaves(jp), jax.tree.leaves(g)):
            assert a.dtype == tdt
            big = np.abs(gl) > 1e-6 * np.abs(gl).max()
            np.testing.assert_allclose(_np(a)[big], _np(b)[big], rtol=p_rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_in_place_equals_functional(dtype):
    _, tp, grads, _, tdt = _adam_tree(dtype, seed=1)
    tc = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    fp, fs = tp, t_adamw.init_state(tp)
    ip = T.tree_map(lambda t: t.clone(), tp)
    is_ = t_adamw.init_state(ip)
    ids = [id(t) for t in T.leaves(ip)] + [id(t) for t in T.leaves(is_["m"])]
    for g in grads:
        tg = T.tree_map(lambda a: torch.from_numpy(a).to(tdt), g)
        fp, fs, finfo = t_adamw.apply_updates(fp, tg, fs, tc)
        iinfo = t_adamw.apply_updates_(ip, tg, is_, tc)
        assert torch.equal(finfo["grad_norm"], iinfo["grad_norm"])
    assert ids == [id(t) for t in T.leaves(ip)] + [id(t) for t in T.leaves(is_["m"])]
    for a, b in zip(T.leaves((fp, fs)), T.leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the functional form leaves its inputs as they were
    assert all(torch.equal(a, b) for a, b in
               zip(T.leaves(tp), T.leaves(_adam_tree(dtype, seed=1)[1])))


# -------------------------------------------------------------- compress
def _compress_cases():
    rng = np.random.RandomState(3)
    zero_block = rng.randn(3 * 1024).astype(np.float32)
    zero_block[1024:2048] = 0.0
    big = (rng.randn(5, 700) * 10.0 ** rng.uniform(-20, 20, size=(5, 700))).astype(np.float32)
    return {"ragged": rng.randn(7, 333).astype(np.float32), "zero_block": zero_block,
            "large_range": big, "halves": (np.arange(2048, dtype=np.float32) - 1024) / 2}


@pytest.mark.parametrize("case", ["ragged", "zero_block", "large_range", "halves"])
def test_int8_compression_is_bit_exact(case):
    x = _compress_cases()[case]
    jq, js = j_compress.quantize_int8(jnp.asarray(x))
    tq, ts = t_compress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    jd = j_compress.dequantize_int8(jq, js, x.shape, jnp.float32)
    td = t_compress.dequantize_int8(tq, ts, x.shape, torch.float32)
    np.testing.assert_array_equal(td.numpy().view(np.int32), np.asarray(jd).view(np.int32))
    assert t_compress.compression_ratio(x.shape) == j_compress.compression_ratio(x.shape)
    assert t_compress.BLOCK == j_compress.BLOCK


def test_compressed_psum_waits_for_a9():
    """``compressed_psum`` is ported with the multi-device slice (ROADMAP
    A9a): a collective, it runs inside ``parallel.spmd.shard_map`` (held
    against the reference's in ``tests/test_torch_parallel.py``) and,
    like ``jax.lax.psum``, refuses to run outside one."""
    from repro_torch.parallel import spmd

    with pytest.raises(NameError, match="shard_map"):
        t_compress.compressed_psum(torch.ones(4), "data")
    x = torch.linspace(-1, 1, 8)
    fn = spmd.shard_map(lambda v: t_compress.compressed_psum(v, "data"),
                        spmd.Mesh(["cpu"] * 2, ("data",)),
                        in_specs=(spmd.P(),), out_specs=(spmd.P(), spmd.P()))
    summed, residual = fn(x)
    q, s = t_compress.quantize_int8(x)
    deq = t_compress.dequantize_int8(q, s, x.shape, torch.float32)
    assert torch.equal(summed, deq + deq) and torch.equal(residual, x - deq)


# --------------------------------------------------------- data pipeline
@pytest.mark.parametrize("kind", ["synthetic", "sharded", "memmap"])
def test_pipeline_batches_equal_reference(kind, tmp_path):
    kw = {"synthetic": dict(vocab=128, seq_len=16, global_batch=4, seed=7),
          "sharded": dict(vocab=1000, seq_len=8, global_batch=12, n_shards=3, shard_id=2),
          "memmap": dict(vocab=100, seq_len=16, global_batch=2, kind="memmap",
                         path=str(tmp_path / "toks.bin"))}[kind]
    if kind == "memmap":
        j_pipe.build_token_file(kw["path"], 4096, vocab=100, seed=1)
        t_pipe.build_token_file(str(tmp_path / "t.bin"), 4096, vocab=100, seed=1)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "toks.bin").read_bytes()
    jp, tp = j_pipe.DataPipeline(j_pipe.DataConfig(**kw)), t_pipe.DataPipeline(
        t_pipe.DataConfig(**kw))
    try:
        for _ in range(4):
            a, b = jp.next(), tp.next()
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    finally:
        jp.close()
        tp.close()


def test_pipeline_determinism_and_restore():
    cfg = t_pipe.DataConfig(vocab=128, seq_len=8, global_batch=4, seed=7)
    p1 = t_pipe.DataPipeline(cfg)
    batches = [p1.next() for _ in range(5)]
    p1.close()
    p2 = t_pipe.DataPipeline(cfg, t_pipe.PipelineState(step=3))
    b3 = p2.next()
    p2.close()
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])


def test_pipeline_shards_are_disjoint_streams():
    a = t_pipe.TokenStream(t_pipe.DataConfig(vocab=128, seq_len=8, global_batch=8,
                                             n_shards=2, shard_id=0))
    b = t_pipe.TokenStream(t_pipe.DataConfig(vocab=128, seq_len=8, global_batch=8,
                                             n_shards=2, shard_id=1))
    ba, bb = a.batch_at(0), b.batch_at(0)
    assert ba["tokens"].shape == (4, 8)
    assert not np.array_equal(ba["tokens"], bb["tokens"])


def test_labels_are_shifted_tokens():
    b = t_pipe.TokenStream(t_pipe.DataConfig(vocab=64, seq_len=8, global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 50), st.integers(1, 4))
def test_property_pipeline_state_is_pure_function_of_step(step, shards):
    cfg = t_pipe.DataConfig(vocab=64, seq_len=4, global_batch=4 * shards, n_shards=shards,
                            shard_id=0)
    s = t_pipe.TokenStream(cfg)
    np.testing.assert_array_equal(s.batch_at(step)["tokens"], s.batch_at(step)["tokens"])


# ------------------------------------------------------------ checkpoints
def _ckpt_state(rng):
    w = rng.randn(2, 3).astype(np.float32)
    return {"params": {"w": w, "blocks": {"b": rng.randn(4).astype(np.float32),
                                          "a": rng.randn(2, 2).astype(np.float32)}},
            "opt_state": {"m": [rng.randn(3).astype(np.float32)],
                          "step": np.asarray(5, np.int32)},
            "data": {"step": np.asarray(9, np.int64)}}


def _as_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_checkpoint_atomicity_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    state = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}
    for s in (1, 2, 3, 4, 5):
        t_ckpt.save(d, s, state, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2 and steps[-1].endswith(f"{5:010d}")
    assert not any(x.startswith("tmp.") for x in os.listdir(d))
    assert t_ckpt.latest_step(d) == 5 and t_ckpt.latest_step(str(tmp_path / "none")) is None
    step, got = t_ckpt.restore(d, {"params": {"w": torch.zeros((2, 3))}}, device="cpu")
    assert step == 5
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.restore(d, {"params": {"w": torch.zeros(1), "x": torch.zeros(1)}}, device="cpu")


def test_checkpoints_are_read_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    state = _ckpt_state(rng)
    j_ckpt.save(str(tmp_path / "j"), 3, state)
    step, got = t_ckpt.restore(str(tmp_path / "j"), _as_torch(state), device="cpu")
    assert step == 3
    for a, b in zip(T.leaves(got), T.leaves(state)):
        assert isinstance(a, torch.Tensor) and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    t_ckpt.save(str(tmp_path / "t"), 4, _as_torch(state))
    step, got = j_ckpt.restore(str(tmp_path / "t"), state)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_files_are_byte_equal(tmp_path):
    """The same tree (with a bf16 leaf) saved by each package: the same
    ``a{i}`` arrays, byte for byte, and the same manifest keys."""
    rng = np.random.RandomState(1)
    state = _ckpt_state(rng)
    bf = rng.randn(3, 5).astype(np.float32)
    jstate = dict(state, params=dict(state["params"], h=jnp.asarray(bf, jnp.bfloat16)))
    tstate = _as_torch(state)
    tstate["params"]["h"] = torch.from_numpy(bf).to(torch.bfloat16)
    jdir, tdir = j_ckpt.save(str(tmp_path / "j"), 1, jstate), t_ckpt.save(
        str(tmp_path / "t"), 1, tstate)
    for name in ("params", "opt_state", "data"):
        with np.load(os.path.join(jdir, f"{name}.npz")) as a, \
                np.load(os.path.join(tdir, f"{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    mj, mt = (json.load(open(os.path.join(d, "manifest.json"))) for d in (jdir, tdir))
    assert mj["step"] == mt["step"]
    assert {n: t["keys"] for n, t in mj["trees"].items()} == {
        n: t["keys"] for n, t in mt["trees"].items()}


def test_bf16_checkpoint_restores_exact_bits_c12(tmp_path):
    """ROADMAP C12: the reference saves a bf16 leaf as ``V2`` and its
    restore cannot cast it back; the port's restore gives the saved bits
    (from either package's file)."""
    rng = np.random.RandomState(2)
    w = jnp.asarray(rng.randn(4, 6), jnp.bfloat16)
    j_ckpt.save(str(tmp_path / "j"), 1, {"params": {"w": w}})
    with pytest.raises(ValueError):
        j_ckpt.restore(str(tmp_path / "j"), {"params": {"w": w}})
    want = torch.from_numpy(np.asarray(w).view(np.int16).copy())
    like = {"params": {"w": torch.zeros((4, 6), dtype=torch.bfloat16)}}
    _, got = t_ckpt.restore(str(tmp_path / "j"), like, device="cpu")
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16), want)
    t_ckpt.save(str(tmp_path / "t"), 1, got)
    _, again = t_ckpt.restore(str(tmp_path / "t"), like, device="cpu")
    assert torch.equal(again["params"]["w"].view(torch.int16), want)


def test_checkpoint_restore_defaults_to_the_card_and_shardings_wait_for_a9(tmp_path):
    """Restore defaults to the card; since A9b ``shardings=`` places a tree
    on a mesh (``tests/test_torch_sharding.py`` holds it across meshes),
    and a sharding tree of anything but ``Sharding`` leaves is refused."""
    from repro_torch.parallel import sharding as t_shd
    from repro_torch.parallel.spmd import Mesh, P, Placed

    t_ckpt.save(str(tmp_path), 1, {"params": {"w": torch.ones(2)}})
    like = {"params": {"w": torch.zeros(2)}}
    with pytest.raises(TypeError, match="Sharding"):
        t_ckpt.restore(str(tmp_path), like, shardings={"params": {"w": object()}}, device="cpu")
    mesh = Mesh(["cpu"] * 2, ("x",))
    _, out = t_ckpt.restore(str(tmp_path), like,
                            shardings={"params": t_shd.make_sharding(mesh, {"w": P("x")})})
    assert isinstance(out["params"]["w"], Placed)
    assert torch.equal(t_shd.assemble(out["params"])["w"], torch.ones(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_ckpt.restore(str(tmp_path), like)


# ---------------------------------------------------------- a train step
def _jax_step(name):
    cfg = j_configs.get(name).scaled()
    m = j_build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    batch = j_batch(cfg, "train", 2, 32, seed=1)
    (loss, _), grads = jax.value_and_grad(lambda p: m.loss(p, batch, remat=True),
                                          has_aux=True)(params)
    return params, float(loss), grads


def _torch_step(name, jparams, remat):
    cfg = api.configs.get(name).scaled()
    model = t_build(cfg)
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for p in T.leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss(params, t_batch(cfg, "train", 2, 32, seed=1, device="cpu"),
                         remat=remat)
    loss.backward()
    return float(loss.detach()), params


def _hold_grads(got_params, want_grads, what):
    want = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    got = T.flatten_with_path(got_params)[0]
    assert [T.key_path(p) for p, _ in got] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp) for kp, _ in want]
    for (path, p), (_, g) in zip(got, want):
        g = _np(g)
        assert p.grad is not None, f"{what}: no gradient reaches {T.key_path(path)}"
        err = float(np.abs(_np(p.grad) - g).max())
        bound = STEP_GRAD_RTOL * (1.0 + float(np.abs(g).max()))
        assert err <= bound, f"{what}: {T.key_path(path)} differs by {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    """``test_arch_smoke.py::test_train_step_smoke``'s step, held against
    ``jax.value_and_grad`` on the same weights and batch; the port's
    remat changes nothing."""
    jparams, jloss, jgrads = _jax_step(name)
    loss, params = _torch_step(name, jparams, remat=True)
    np.testing.assert_allclose(loss, jloss, rtol=STEP_LOSS_RTOL)
    _hold_grads(params, jgrads, f"{name} (remat)")
    loss_nr, params_nr = _torch_step(name, jparams, remat=False)
    np.testing.assert_allclose(loss_nr, loss, rtol=STEP_LOSS_RTOL)
    for a, b in zip(T.leaves(params_nr), T.leaves(params)):
        g = _np(b.grad)
        assert float(np.abs(_np(a.grad) - g).max()) <= STEP_GRAD_RTOL * (
            1.0 + float(np.abs(g).max()))


REMAT_SITES = {"llama3-8b": ("lm", "block_apply"), "zamba2-2.7b": ("hybrid", "_group"),
               "seamless-m4t-large-v2": ("encdec", "_dec_block"),
               "xlstm-125m": ("xlstm_model", "slstm_block_apply")}


@pytest.mark.parametrize("name", sorted(REMAT_SITES))
def test_remat_recomputes_each_body_in_the_backward_pass(name, monkeypatch):
    """Where the reference wraps a body in ``jax.checkpoint``, the port
    runs it under ``torch.utils.checkpoint``: with ``remat`` the body runs
    again in the backward pass, without it once."""
    import importlib

    mod_name, fn_name = REMAT_SITES[name]
    mod = importlib.import_module(f"repro_torch.models.{mod_name}")
    real = getattr(mod, fn_name)
    calls = []
    monkeypatch.setattr(mod, fn_name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = api.configs.get(name).scaled()
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = t_batch(cfg, "train", 2, 16, seed=1, device="cpu")
    counts = {}
    for remat in (False, True):
        calls.clear()
        for p in T.leaves(params):
            p.grad = None
            p.requires_grad_(True)
        model.loss(params, batch, remat=remat)[0].backward()
        counts[remat] = len(calls)
    assert counts[False] > 0 and counts[True] == 2 * counts[False], counts


# ------------------------------------------------------------ the Trainer
def _mk_trainer(tmp, steps=12, ckpt_every=4, seed=0):
    cfg = _tiny(api.configs)
    data = api.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=seed)
    opt = api.adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    tc = api.TrainConfig(steps=steps, ckpt_dir=tmp, ckpt_every=ckpt_every, log_every=1)
    return api.Trainer(api.build_model(cfg), opt, data, tc, device="cpu")


def test_trainer_matches_reference():
    """12 steps from the reference trainer's initial weights, on the same
    batches: every loss within ``TRAINER_RTOL``."""
    cfg = _tiny(j_configs)
    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=12)
    jtr = j_loop.Trainer(j_build(cfg), j_adamw.AdamWConfig(**opt), j_pipe.DataConfig(**data),
                         j_loop.TrainConfig(steps=12, log_every=1))
    init = jax.tree.map(np.asarray, jtr.params)
    ttr = api.Trainer(api.build_model(_tiny(api.configs)), api.adamw.AdamWConfig(**opt),
                      api.DataConfig(**data), api.TrainConfig(steps=12, log_every=1),
                      device="cpu")
    ttr.params = api.params_from_jax(init, device="cpu")
    ttr.opt_state = api.adamw.init_state(ttr.params)
    try:
        want = [h["loss"] for h in jtr.run()["history"]]
        got = ttr.run()["history"]
    finally:
        jtr.pipeline.close()
        ttr.pipeline.close()
    assert [h["step"] for h in got] == list(range(1, 13))
    np.testing.assert_allclose([h["loss"] for h in got], want, rtol=TRAINER_RTOL)
    assert all(h["dt"] > 0 and np.isfinite(h["grad_norm"]) and h["lr"] > 0 for h in got)


def test_training_reduces_loss(tmp_path):
    tr = _mk_trainer(str(tmp_path / "ck"), steps=30)
    try:
        out = tr.run()
    finally:
        tr.pipeline.close()
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0], f"no learning: {losses[0]} -> {losses[-1]}"
    assert np.isfinite(losses[-1])
    assert all(p.device.type == "cpu" for p in T.leaves(tr.params))


def test_fault_recovery_resumes_bit_exact(tmp_path):
    ref = t_loop.run_with_restarts(lambda: _mk_trainer(str(tmp_path / "a")))
    fault = t_loop.FaultInjector(fail_at_step=6)
    out = t_loop.run_with_restarts(lambda: _mk_trainer(str(tmp_path / "b")), fault=fault)
    assert out["restarts"] == 1 and ref["restarts"] == 0
    ref_losses = {h["step"]: h["loss"] for h in ref["history"]}
    got_losses = {h["step"]: h["loss"] for h in out["history"]}
    for s in (10, 11, 12):
        np.testing.assert_allclose(got_losses[s], ref_losses[s], rtol=1e-6,
                                   err_msg=f"step {s} diverged after restart")


def test_ambient_fault_plan_triggers_restart(tmp_path):
    with t_faults.inject(t_faults.fail_when("train.step",
                                            lambda ctx: ctx["step"] == 6)) as plan:
        out = t_loop.run_with_restarts(lambda: _mk_trainer(str(tmp_path / "amb")))
    assert plan.fired_counts() == {"train.step": 1}
    assert out["restarts"] == 1
    assert out["history"][-1]["step"] == 12


def test_fault_injector_shim_is_one_shot():
    fi = t_loop.FaultInjector(fail_at_step=2)
    assert not fi.fired
    fi.check(1)
    with pytest.raises(RuntimeError):
        fi.check(2)
    assert fi.fired
    fi.check(2)


def test_straggler_watchdog_flags_slow_steps():
    w = t_loop.StragglerWatchdog(factor=3.0)
    for i in range(20):
        w.record(i, 0.1)
    w.record(20, 1.0)
    assert w.flagged and w.flagged[0]["step"] == 20


def test_trainer_defaults_to_the_card():
    cfg = _tiny(api.configs)
    args = (api.build_model(cfg), api.adamw.AdamWConfig(), api.DataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=2), api.TrainConfig(steps=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Trainer(*args)


# ------------------------------------------------------------------- C11
def _c11_inputs():
    rng = np.random.RandomState(11)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"x": f(8, 16), "w": f(16, 24), "q": f(1, 2, 64, 16), "k": f(1, 2, 64, 16),
            "v": f(1, 2, 64, 16), "ld": -np.abs(f(1, 2, 64)), "g": np.abs(f(1, 2, 64)),
            "A": -np.abs(f(2))}


def _c11_calls(lib):
    """Each kernel entry point of one package as ``(name, fn(inputs),
    argument differentiated)``."""
    if lib == "jax":
        prog = j_single_op("O[i, j] += X[i, c] * W[c, j]",
                           {"X": ((8, 16), "float32"), "W": ((16, 24), "float32"),
                            "O": ((8, 24), "float32")}, out="O")
        jit = j_stripe_jit(prog, j_get_config("cpu_test"), "pallas", interpret=True,
                           cache=JCache(use_disk=False), use_disk=False)
        return {
            "oplib.linear": lambda a: j_oplib.linear(a["x"], a["w"]),
            "stripe_jit": lambda a: jit({"X": a["x"], "W": a["w"]})["O"],
            "stripe_matmul": lambda a: j_matmul(a["x"], a["w"]),
            "flash_attention": lambda a: j_flash(a["q"], a["k"], a["v"], interpret=True),
            "chunked_gla": lambda a: j_gla(a["q"], a["k"], a["v"], a["ld"], a["g"], chunk=16,
                                           interpret=True),
            "mlstm_chunk": lambda a: j_mlstm(a["q"], a["k"], a["v"], a["g"], a["ld"],
                                             chunk=16, interpret=True),
            "ssd_chunk": lambda a: j_ssd(a["q"], a["g"], a["A"], a["k"], a["v"], chunk=16,
                                         interpret=True),
        }
    prog = t_single_op("O[i, j] += X[i, c] * W[c, j]",
                       {"X": ((8, 16), "float32"), "W": ((16, 24), "float32"),
                        "O": ((8, 24), "float32")}, out="O")
    jit = t_stripe_jit(prog, t_get_config("cpu_test"), "cuda", cache=TCache(use_disk=False),
                       use_disk=False, device="cpu")
    return {
        "oplib.linear": lambda a: t_oplib.linear(a["x"], a["w"]),
        "stripe_jit": lambda a: jit({"X": a["x"], "W": a["w"]})["O"],
        "stripe_matmul": lambda a: t_matmul(a["x"], a["w"]),
        "flash_attention": lambda a: t_flash(a["q"], a["k"], a["v"]),
        "chunked_gla": lambda a: t_gla(a["q"], a["k"], a["v"], a["ld"], a["g"], chunk=16),
        "mlstm_chunk": lambda a: t_mlstm(a["q"], a["k"], a["v"], a["g"], a["ld"], chunk=16),
        "ssd_chunk": lambda a: t_ssd(a["q"], a["g"], a["A"], a["k"], a["v"], chunk=16),
    }


WRT = {"oplib.linear": "w", "stripe_jit": "w", "stripe_matmul": "w"}


def test_c11_kernels_refuse_autograd(backends):
    """ROADMAP C11: under autograd the reference's kernels raise (its
    ``pallas_interpret`` backend and ``interpret=True`` kernels under
    ``jax.grad``), and so does every kernel entry point of the port (the
    ``cuda`` backend and the kernels on CPU tensors, where the plain
    versions would otherwise differentiate).  Under ``torch.no_grad()``,
    or on inputs that do not require grad, the port's outputs are as
    before, and equal."""
    inputs = _c11_inputs()
    j_oplib.set_backend("pallas_interpret")
    t_oplib.set_backend("cuda")
    jcalls, tcalls = _c11_calls("jax"), _c11_calls("torch")
    assert sorted(jcalls) == sorted(tcalls)
    for name in jcalls:
        wrt = WRT.get(name, "q")
        ja = {k: jnp.asarray(v) for k, v in inputs.items()}

        def jloss(x, name=name, wrt=wrt):
            return jnp.sum(jcalls[name](dict(ja, **{wrt: x})))

        with pytest.raises((ValueError, AssertionError)):
            jax.grad(jloss)(ja[wrt])
        ta = {k: torch.from_numpy(v) for k, v in inputs.items()}
        plain = tcalls[name](ta)
        ta[wrt] = ta[wrt].clone().requires_grad_(True)
        with pytest.raises(KernelAutogradError, match="C11"):
            tcalls[name](ta)
        with torch.no_grad():
            assert torch.equal(tcalls[name](ta), plain), name
    with pytest.raises(KernelAutogradError, match="C11"):
        _mk_trainer("")
    t_oplib.set_backend("torch")
    _mk_trainer("").pipeline.close()
