"""The port's A9b half (``parallel/sharding.py``, ``constrain.py``,
``sharded.py`` and ``train/checkpoint.restore(shardings=)``) against the
JAX package, on CPU ranks of the port (``Mesh(["cpu"] * n)``).

* **Spec parity.**  ``param_specs``, ``opt_specs``, ``batch_specs`` and
  ``cache_specs`` equal the reference's path by path for all ten registry
  configs at full width (the port's shapes on the ``meta`` device, the
  reference's from ``jax.eval_shape``), under ``DEFAULT_AXES``,
  ``{"data": 2, "model": 4}`` and ``{"data": 8, "model": 1}``, both cache
  branches (batch on 'data'; batch 1, sequence on 'data').
* **The dp/tp step.**  The reference's own test
  (``tests/test_distributed.py::test_dp_tp_train_step_matches_single_device``)
  fails in JAX 0.9 (ROADMAP C0): its single-device loss computes, but the
  meshed ``jax.jit`` raises ``ShardingTypeError`` at
  ``repro/nn/core.py:130`` (``jnp.take``), unable to resolve the output
  sharding of a gather of a ``float32[128@model,64]`` table by
  ``int32[8@data,32]`` tokens.  So the reference has no meshed loss, and
  the port's sharded step is held against the reference's single-device
  loss and ``jax.grad`` (the ``ref`` of that test) and against the port's
  own single-device ``loss_and_grads``: for the seven LM-family configs on
  ``(2, 4)``, ``(1, 4)`` and ``(4, 2)`` ``('data', 'model')`` meshes, the
  loss within rtol 2e-4 (the reference test's), each gradient leaf within
  1e-4 x (1 + its largest |g|), and one ``sharded_train_step`` against
  ``adamw.apply_updates`` (each parameter within 1e-5 x (1 + max), under
  the default ``AdamWConfig``, whose warm-up keeps the first step's size
  at 3e-6: Adam's first step is ``sign(g)``, so a larger one turns
  gradient rounding near zero into parameter differences).
* **MoE.**  A capacity that drops tokens (``capacity_factor`` 0.5): the
  capacity from the global token count, the positions in the global token
  order and the auxiliary loss from the global means, each of which a
  per-rank version would move.
* **Sharded prefill and decode** against the port's and the reference's
  single-device ``prefill`` / ``decode_step`` on both cache branches, the
  logits within 1e-4 x (1 + max) and the cache written as the
  single-device one.
* **constrain**: the identity off a mesh; inside ``shard_map`` the call
  sites it records in a loss and in a decode step are the reference's
  (``lm.py:80`` or ``:89``, ``:109``; ``moe.py:68``, ``:78``, ``:93``);
  a wrong local shape raises.
* **restore(shardings=)**: a checkpoint saved from ``(2, 4)`` restores
  onto ``(1, 4)``, ``(8,)`` and one device bit-equal, and the reference's
  ``restore`` reads the same files to the same values.
"""
import ast
import collections
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import input_specs as j_input_specs  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402
from repro.parallel import sharding as j_shd  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import input_specs as t_input_specs  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402
from repro_torch.nn.attention import attention  # noqa: E402
from repro_torch.nn.core import apply_norm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import constrain as t_constrain  # noqa: E402
from repro_torch.parallel import sharded  # noqa: E402
from repro_torch.parallel import sharding as t_shd  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.spmd import Mesh, P  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ["llama3-8b", "chatglm3-6b", "nemotron-4-15b", "qwen3-4b", "dbrx-132b",
       "qwen3-moe-30b-a3b", "internvl2-26b", "zamba2-2.7b", "xlstm-125m",
       "seamless-m4t-large-v2"]
LM_FAMILY = ALL[:7]
MESHES = [(2, 4), (1, 4), (4, 2)]
SIZES = [j_shd.DEFAULT_AXES, {"data": 2, "model": 4}, {"data": 8, "model": 1}]
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL, LOGIT_RTOL = 2e-4, 1e-4, 1e-5, 1e-4
# a failing rank fails the call within this many seconds instead of hanging
TIMEOUT = 120


def _mesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape), names)


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    return float((got - want).abs().max() / (1.0 + want.abs().max()))


def _np(x):
    return torch.from_numpy(np.array(x, copy=True))


# --------------------------------------------------------------- spec parity
def _j_items(tree):
    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): tuple(s)
            for kp, s in pairs}


def _t_items(tree):
    """Path -> spec entries; a one-name group ``('data',)`` as ``'data'``,
    as ``jax.sharding.PartitionSpec`` stores it (the same split)."""
    out = {}

    def entry(e):
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e

    def walk(t, path):
        if isinstance(t, P):
            out["/".join(path)] = tuple(entry(e) for e in t)
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, c in enumerate(t):
                walk(c, path + (str(i),))
    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _full_shapes(name):
    jm = j_build(j_configs.get(name))
    tm = api.build_model(api.configs.get(name))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator(), device="meta")
    return jm, tm, jp, tp


@pytest.mark.parametrize("name", ALL)
def test_param_and_opt_specs_equal_the_reference(name):
    jm, tm, jp, tp = _full_shapes(name)
    assert sorted(_t_items(t_shd.param_specs(tp))) == sorted(
        _j_items(j_shd.param_specs(jp)))
    for sizes in SIZES:
        js, ts = j_shd.param_specs(jp, sizes), t_shd.param_specs(tp, sizes)
        assert _t_items(ts) == _j_items(js), sizes
        assert _t_items(t_shd.opt_specs(ts, None)) == _j_items(j_shd.opt_specs(js, None))


@pytest.mark.parametrize("name", ALL)
def test_batch_and_cache_specs_equal_the_reference(name):
    jm, tm, _, _ = _full_shapes(name)
    for shape in ("train_4k", "prefill_32k"):
        jin = j_input_specs(j_configs.get(name), J_SHAPES[shape])
        tin = t_input_specs(api.configs.get(name), J_SHAPES[shape])
        for sizes in SIZES:
            for dp in (("pod", "data"), ("data",)):
                assert _t_items(t_shd.batch_specs(tin, dp, sizes)) == _j_items(
                    j_shd.batch_specs(jin, dp, sizes)), (shape, sizes, dp)
    for batch, length in ((32, 4096), (1, 32768)):       # batch on 'data'; sequence on 'data'
        jc = jax.eval_shape(lambda: jm.init_cache(batch, length))
        tc = tm.init_cache(batch, length, device="meta")
        for sizes in SIZES:
            dps = sizes.get("data", 1)
            got = _t_items(t_shd.cache_specs(tc, batch, dps, ("data",), sizes))
            assert got == _j_items(j_shd.cache_specs(jc, batch, dps, ("data",), sizes)), \
                (batch, sizes)


def test_both_cache_branches_are_covered():
    _, tm, _, _ = _full_shapes("llama3-8b")
    sizes = {"data": 2, "model": 4}
    on_batch = t_shd.cache_specs(tm.init_cache(32, 4096, device="meta"), 32, 2, ("data",), sizes)
    on_seq = t_shd.cache_specs(tm.init_cache(1, 32768, device="meta"), 1, 2, ("data",), sizes)
    assert on_batch["k"] == P(None, ("data",), "model", None, None)
    assert on_seq["k"] == P(None, None, ("data",), "model", None)


# ------------------------------------------------------------- the dp/tp step
def _scaled(registry, name, capacity):
    cfg = registry.get(name).scaled()
    if capacity is None:
        return cfg
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


@functools.lru_cache(maxsize=None)
def _reference(name, capacity=None):
    """The reference's single-device loss and gradients (the ``ref`` of
    test_distributed.py), and the port's, on the same weights and batch."""
    jcfg = _scaled(j_configs, name, capacity)
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jbatch = j_batch(jcfg, "train", 8, 32)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jbatch, remat=False)[0]))(
        jparams)
    model = api.build_model(_scaled(api.configs, name, capacity))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = {k: _np(v) for k, v in jbatch.items()}
    loss, grads = loss_and_grads(model, params, batch, remat=False)
    return (model, params, batch, float(jloss), [_np(g) for g in jax.tree.leaves(jgrads)],
            loss, grads)


def _hold_loss_and_grads(name, shape, capacity=None):
    model, params, batch, jloss, jgrads, loss, grads = _reference(name, capacity)
    mesh = _mesh(shape)
    sloss, sgrads = sharded.sharded_loss_and_grads(model, mesh, params, batch, timeout=TIMEOUT)
    np.testing.assert_allclose(float(sloss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(sloss), float(loss), rtol=LOSS_RTOL)
    paths = [T.key_path(p) for p, _ in T.flatten_with_path(params)[0]]
    for path, got, want, mine in zip(paths, sgrads, jgrads, grads):
        assert _rel(got, want) <= GRAD_RTOL, (path, _rel(got, want))
        assert _rel(got, mine) <= GRAD_RTOL, (path, _rel(got, mine))
    return model, params, batch, grads, mesh


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", LM_FAMILY)
def test_dp_tp_step_matches_single_device(name, shape):
    model, params, batch, grads, mesh = _hold_loss_and_grads(name, shape)
    # one AdamW step on the placed shards against apply_updates
    cfg = adamw.AdamWConfig()
    state = adamw.init_state(params)
    want_p, want_s, want_info = adamw.apply_updates(
        params, T.unflatten(T.flatten(params)[1], grads), state, cfg)
    pp, ps = sharded.place_params(mesh, params), sharded.place_opt_state(mesh, state)
    info = sharded.sharded_train_step(model, mesh, pp, ps, batch, cfg, timeout=TIMEOUT)
    np.testing.assert_allclose(float(info["grad_norm"]), float(want_info["grad_norm"]),
                               rtol=GRAD_RTOL)
    got_p, got_s = t_shd.assemble(pp), t_shd.assemble(ps)
    for a, b in zip(T.leaves(got_p), T.leaves(want_p)):
        assert _rel(a, b) <= PARAM_RTOL
    for key in ("m", "v"):
        for a, b in zip(T.leaves(got_s[key]), T.leaves(want_s[key])):
            assert _rel(a, b) <= GRAD_RTOL
    assert int(got_s["step"]) == 1


def _dropped(name, capacity):
    """The (token, choice) pairs the capacity drops in the first layer of
    the single-device forward."""
    model, params, batch = _reference(name, capacity)[:3]
    cfg = model.cfg
    x = params["embed"][batch["tokens"].long()]
    blk = lm.layer(params["blocks"], 0)
    x = x + attention(blk["attn"], apply_norm(blk["ln1"], x, cfg.norm), cfg)[0]
    xt = apply_norm(blk["ln2"], x, cfg.norm).reshape(-1, cfg.d_model)
    _, idx = t_moe.route(blk["moe"], xt, cfg)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = max(int(np.ceil(cfg.moe.capacity_factor * xt.shape[0] * k / e)), 4)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=e)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_step_where_the_capacity_drops_tokens(shape):
    """With half the default capacity, tokens overflow; a capacity or
    positions counted per 'data' rank, or an auxiliary loss averaged over
    the ranks, would move the loss or the gradients past the bounds."""
    assert _dropped("qwen3-moe-30b-a3b", 0.5) > 0
    _hold_loss_and_grads("qwen3-moe-30b-a3b", shape, capacity=0.5)


# --------------------------------------------------------- prefill and decode
SERVE_CASES = [("llama3-8b", (2, 4), 8), ("llama3-8b", (2, 4), 1), ("llama3-8b", (2, 2), 1),
               ("chatglm3-6b", (1, 4), 4), ("qwen3-moe-30b-a3b", (2, 4), 8),
               ("qwen3-moe-30b-a3b", (2, 2), 1), ("internvl2-26b", (2, 2), 2),
               ("internvl2-26b", (2, 2), 1), ("qwen3-4b", (4, 2), 4)]


@pytest.mark.parametrize("name,shape,batch", SERVE_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-b{b}" for n, s, b in SERVE_CASES])
def test_sharded_prefill_and_decode_match_single_device(name, shape, batch):
    jcfg = j_configs.get(name).scaled()
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jb = j_batch(jcfg, "prefill", batch, 12)
    max_len = 32 + (jcfg.frontend_len if jcfg.frontend == "patches" else 0)
    jlog, jcache = jm.prefill(jparams, jb, jm.init_cache(batch, max_len))
    model = api.build_model(api.configs.get(name).scaled())
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tb = {k: _np(v) for k, v in jb.items()}
    log, cache = model.prefill(params, tb, model.init_cache(batch, max_len, device="cpu"))
    mesh = _mesh(shape)
    placed = sharded.place_params(mesh, params)
    scache = sharded.init_cache(model, mesh, batch, max_len)
    slog, scache = sharded.sharded_prefill(model, mesh, placed, tb, scache, timeout=TIMEOUT)
    assert _rel(slog, log) <= LOGIT_RTOL and _rel(slog, _np(jlog)) <= LOGIT_RTOL
    tok = log[:, -1:, :model.cfg.vocab].argmax(-1).int()
    for _ in range(3):
        jlog, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok.numpy()))
        log, cache = model.decode_step(params, cache, tok)
        slog, scache = sharded.sharded_decode_step(model, mesh, placed, scache, tok,
                                                   timeout=TIMEOUT)
        assert _rel(slog, log) <= LOGIT_RTOL and _rel(slog, _np(jlog)) <= LOGIT_RTOL
        tok = log[:, -1:, :model.cfg.vocab].argmax(-1).int()
    full = t_shd.assemble(scache)
    for key in ("k", "v"):
        assert _rel(full[key], cache[key]) <= LOGIT_RTOL
    assert full["pos"].tolist() == cache["pos"].tolist()


def test_sharded_decode_on_the_kernel_backend_of_cpu_ranks():
    """oplib on ``cuda`` from 4 rank threads at once (each runs the
    contraction kernel's plain version on its CPU shard) matches the
    ``torch`` backend."""
    model = api.build_model(api.configs.get("llama3-8b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = _mesh((1, 4))
    placed = sharded.place_params(mesh, params)
    batch = api.make_batch(model.cfg, "prefill", 4, 8, device="cpu")
    out = {}
    old = t_oplib.get_backend()
    try:
        for backend in ("torch", "cuda"):
            t_oplib.set_backend(backend)
            cache = sharded.init_cache(model, mesh, 4, 16)
            log, cache = sharded.sharded_prefill(model, mesh, placed, batch, cache,
                                                 timeout=TIMEOUT)
            out[backend] = sharded.sharded_decode_step(
                model, mesh, placed, cache, log[:, -1:, :128].argmax(-1).int(),
                timeout=TIMEOUT)[0]
    finally:
        t_oplib.set_backend(old)
    assert _rel(out["cuda"], out["torch"]) <= LOGIT_RTOL


def test_oplib_counts_each_rank_under_contention():
    """Eight rank threads on two cores, the interpreter switching threads
    every 10 us, each running oplib on ``cuda`` 50 times on a unit the
    legality check sends to torch (one row, a fused silu): each rank's
    ``torch_units`` count is exact, which a lost update of the shared
    counts would break."""
    import sys

    mesh = _mesh((8,), ("x",))
    x = torch.ones(1, 64)
    w = torch.ones(64, 32) / 64

    def body(_):
        for _ in range(50):
            t_oplib.linear(x, w, act="silu")
        return torch.zeros(())

    old = (t_oplib.get_backend(), sys.getswitchinterval())
    t_oplib.launches_by_rank.clear()
    try:
        t_oplib.set_backend("cuda")
        sys.setswitchinterval(1e-5)
        spmd.shard_map(body, mesh, P(), P(), timeout=TIMEOUT)(torch.zeros(8))
    finally:
        t_oplib.set_backend(old[0])
        sys.setswitchinterval(old[1])
    assert {r: c.get("torch_units") for r, c in t_oplib.launches_by_rank.items()} == {
        r: 50 for r in range(8)}
    assert any("not a grid index" in why for why in t_oplib.rank_fallbacks.values())


def test_train_step_refuses_unplaced_state_and_a_batch_off_data():
    model = api.build_model(api.configs.get("llama3-8b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = _mesh((2, 4))
    with pytest.raises(TypeError):
        sharded.sharded_train_step(model, mesh, params, adamw.init_state(params),
                                   api.make_batch(model.cfg, "train", 8, 8, device="cpu"),
                                   adamw.AdamWConfig())
    with pytest.raises(ValueError):
        sharded.sharded_loss_and_grads(model, mesh, params,
                                       api.make_batch(model.cfg, "train", 3, 8, device="cpu"))


# ----------------------------------------------------------------- constrain
def _reference_sites():
    """The reference's constrain call sites: (file, top-level function,
    ordinal in it) -> line, from its source."""
    out = {}
    for rel in ("src/repro/models/lm.py", "src/repro/nn/moe.py"):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            calls = sorted(n.lineno for n in ast.walk(fn) if isinstance(n, ast.Call)
                           and getattr(n.func, "id", None) == "constrain")
            for i, line in enumerate(calls):
                out[(os.path.basename(rel), fn.name, i)] = line
    return out


def _port_site(filename, lineno):
    tree = ast.parse(open(filename).read())
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.lineno <= lineno <= fn.end_lineno:
            calls = sorted(n.lineno for n in ast.walk(fn) if isinstance(n, ast.Call)
                           and getattr(n.func, "id", None) == "constrain")
            return os.path.basename(filename), fn.name, calls.index(lineno)
    raise AssertionError(f"no function holds {filename}:{lineno}")


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.ones(4, 3)
    assert t_constrain.constrain(x, "data", None) is x
    with _mesh((2, 4)):
        assert t_constrain.constrain(x, ("pod", "data"), None) is x


def test_constrain_records_the_reference_sites():
    """A MoE config's loss records the reference's no-cache ``_stack``
    site (``lm.py:89``), ``_embed_inputs`` (``:109``) and the three of
    ``moe_apply`` (``moe.py:68, 78, 93``), each once a layer; its decode
    step the cache site (``lm.py:80``) and the three."""
    ref = _reference_sites()
    assert [ref[("lm.py", "_stack", 0)], ref[("lm.py", "_stack", 1)],
            ref[("lm.py", "_embed_inputs", 0)]] == [80, 89, 109]
    assert [ref[("moe.py", "moe_apply", i)] for i in range(3)] == [68, 78, 93]
    model = api.build_model(api.configs.get("qwen3-moe-30b-a3b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = _mesh((2, 4))
    n = model.cfg.n_layers
    moe = {("moe.py", "moe_apply", i): n for i in range(3)}

    def sites(fn):
        with spmd.recording() as calls:
            fn()
        return collections.Counter(_port_site(*site[-1]) for prim, site in calls
                                   if prim == "constrain")

    loss = sites(lambda: sharded.sharded_loss(
        model, mesh, params, api.make_batch(model.cfg, "train", 8, 8, device="cpu")))
    assert loss == {("lm.py", "_stack", 1): n, ("lm.py", "_embed_inputs", 0): 1, **moe}
    cache = sharded.init_cache(model, mesh, 8, 16)
    placed = sharded.place_params(mesh, params)
    decode = sites(lambda: sharded.sharded_decode_step(
        model, mesh, placed, cache, torch.zeros((8, 1), dtype=torch.int32)))
    assert decode == {("lm.py", "_stack", 0): n, **moe}
    assert set(loss) | set(decode) <= set(ref)


def test_constrain_raises_on_a_wrong_local_shape():
    mesh = _mesh((2, 4))

    def body(x):
        t_constrain.constrain(x[:2], "data", None, shape=(8, 4))   # held (4, 4)
        return x

    good = spmd.shard_map(lambda x: t_constrain.constrain(x, "data", None, shape=(8, 4)),
                          mesh, P("data"), P("data"))
    assert torch.equal(good(torch.arange(32.0).reshape(8, 4)), torch.arange(32.0).reshape(8, 4))
    with pytest.raises(ValueError, match="not a block"):
        spmd.shard_map(body, mesh, P("data"), P("data"), timeout=TIMEOUT)(torch.zeros(8, 4))


# ------------------------------------------------------- restore(shardings=)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_onto_other_meshes_is_bit_equal(tmp_path, dtype):
    model = api.build_model(api.configs.get("qwen3-moe-30b-a3b").scaled(dtype=dtype))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = adamw.init_state(params)
    src = _mesh((2, 4))
    t_ckpt.save(str(tmp_path), 7, {"params": sharded.place_params(src, params),
                                   "opt_state": sharded.place_opt_state(src, state)})
    for mesh in (_mesh((1, 4)), _mesh((8,), ("data",))):
        sh = t_shd.make_sharding(mesh, t_shd.param_specs(params, dict(mesh.shape)))
        step, out = t_ckpt.restore(str(tmp_path), {"params": params}, shardings={"params": sh})
        assert step == 7
        for leaf in T.leaves(out["params"]):
            assert isinstance(leaf, spmd.Placed) and leaf.mesh is mesh
        for a, b in zip(T.leaves(t_shd.assemble(out["params"])), T.leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    _, out = t_ckpt.restore(str(tmp_path), {"params": params}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(out["params"]), T.leaves(params)))
    if dtype == "float32":   # the reference cannot cast bf16 back (ROADMAP C12)
        _, ref = j_ckpt.restore(str(tmp_path), {"params": T.tree_map(lambda t: t.numpy(),
                                                                     params)})
        for a, b in zip(jax.tree.leaves(ref["params"]), T.leaves(params)):
            assert np.array_equal(np.asarray(a), b.numpy())
