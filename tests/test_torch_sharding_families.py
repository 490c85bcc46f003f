"""The sharded step of the hybrid, ssm and audio families (zamba2-2.7b,
xlstm-125m, seamless-m4t-large-v2; ``parallel/sharded.py``'s
:class:`Family` table and the hooks in ``nn/ssm.py``, ``nn/xlstm.py``,
``models/hybrid.py``, ``xlstm_model.py`` and ``encdec.py``) against the
JAX package, on CPU ranks of the port (``Mesh(["cpu"] * n)``), at the
registry's ``scaled()`` widths.

The reference's meshed ``jax.jit`` of a loss raises in JAX 0.9 (ROADMAP
C0; ``test_torch_sharding.py`` says where), so, as there, the port's
sharded step is held against the reference's single-device
``jax.value_and_grad``, ``prefill`` and ``decode_step`` and against the
port's own single-device functions:

* **the dp/tp step** on ``(2, 4)``, ``(1, 4)`` and ``(4, 2)``: the loss
  within rtol 2e-4, each gradient leaf within 1e-4 x (1 + its largest
  |g|), then one ``sharded_train_step`` against ``adamw.apply_updates``
  (each parameter within 1e-5 x (1 + max)).  The scaled xLSTM has 2
  heads, which do not divide over 'model' 4 (every rank runs both) and do
  over 'model' 2 (each runs its own);
* **sharded prefill and 3 decode steps**, the logits within 1e-4 x (1 +
  max), and the assembled cache (KV, ``pos``, the recurrent states,
  ``memory``) against the single-device caches.  The cases cover each
  layout ``cache_specs`` gives these families: batch on 'data'; batch 1
  (positions on 'data', the states replicated over it); zamba2 at batch 2
  on ``(2, 2)``, where 'data' lands on a stacked layer dim of the states;
* zamba2 served with ``oplib`` on ``cuda`` from CPU ranks (each rank runs
  the contraction kernel's plain version on its shard);
* the sLSTM's time loop holds no collective (a rank's collectives do not
  grow with the sequence);
* ``restore(shardings=)`` of a hybrid tree (stacked ``(groups,
  per_group, ...)`` leaves) saved from ``(2, 4)`` onto ``(1, 4)``,
  bit-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharded  # noqa: E402
from repro_torch.parallel import sharding as t_shd  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402

from test_torch_sharding import (GRAD_RTOL, LOGIT_RTOL, MESHES, PARAM_RTOL,  # noqa: E402
                                 TIMEOUT, _hold_loss_and_grads, _mesh, _np, _rel)

FAMILIES = ["zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]


# ------------------------------------------------------------- the dp/tp step
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", FAMILIES)
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
    paths = [T.key_path(p) for p, _ in T.flatten_with_path(params)[0]]
    for path, a, b in zip(paths, T.leaves(got_p), T.leaves(want_p)):
        assert _rel(a, b) <= PARAM_RTOL, (path, _rel(a, b))
    for key in ("m", "v"):
        for path, a, b in zip(paths, T.leaves(got_s[key]), T.leaves(want_s[key])):
            assert _rel(a, b) <= GRAD_RTOL, (key, path, _rel(a, b))
    assert int(got_s["step"]) == 1


def test_sharded_loss_matches_single_device():
    """``sharded_loss`` (no gradient) of each family on ``(2, 4)``."""
    for name in FAMILIES:
        model = api.build_model(api.configs.get(name).scaled())
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = api.make_batch(model.cfg, "train", 8, 16, device="cpu")
        want, _ = model.loss(params, batch, remat=False)
        got, metrics = sharded.sharded_loss(model, _mesh((2, 4)), params, batch,
                                            timeout=TIMEOUT)
        np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
        assert float(metrics["loss"]) == float(got)


# --------------------------------------------------------- prefill and decode
SERVE_CASES = [("zamba2-2.7b", (2, 4), 8), ("zamba2-2.7b", (1, 4), 4),
               ("zamba2-2.7b", (2, 2), 1), ("zamba2-2.7b", (2, 2), 2),
               ("xlstm-125m", (2, 4), 8), ("xlstm-125m", (2, 2), 1), ("xlstm-125m", (4, 2), 4),
               ("seamless-m4t-large-v2", (2, 4), 8), ("seamless-m4t-large-v2", (2, 2), 1)]


@pytest.mark.parametrize("name,shape,batch", SERVE_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-b{b}" for n, s, b in SERVE_CASES])
def test_sharded_prefill_and_decode_match_single_device(name, shape, batch):
    jcfg = j_configs.get(name).scaled()
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jb = j_batch(jcfg, "prefill", batch, 12)
    max_len = 32
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
    got = T.flatten_with_path(full)[0]
    assert [T.key_path(p) for p, _ in got] == [T.key_path(p) for p, _ in
                                               T.flatten_with_path(cache)[0]]
    for (path, a), b, c in zip(got, T.leaves(cache), jax.tree.leaves(jcache)):
        assert a.shape == b.shape and a.dtype == b.dtype, T.key_path(path)
        assert _rel(a, b) <= LOGIT_RTOL, (T.key_path(path), _rel(a, b))
        assert _rel(a, _np(c)) <= LOGIT_RTOL, (T.key_path(path), _rel(a, _np(c)))


def test_memory_is_placed_with_the_batch():
    """The encoder's output the prefill places: batch on 'data' where the
    batch divides, else replicated (the reference gives it no spec)."""
    model = api.build_model(api.configs.get("seamless-m4t-large-v2").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for batch, spec in ((4, spmd.P(("data",))), (1, spmd.P(None))):
        mesh = _mesh((2, 2))
        cache = sharded.init_cache(model, mesh, batch, 16)
        assert cache["memory"] is None
        _, cache = sharded.sharded_prefill(
            model, mesh, params, api.make_batch(model.cfg, "prefill", batch, 6, device="cpu"),
            cache, timeout=TIMEOUT)
        mem = cache["memory"]
        assert isinstance(mem, spmd.Placed) and mem.spec == spec
        assert tuple(mem.shape) == (batch, 6, model.cfg.d_model)


def test_hybrid_decode_on_the_kernel_backend_of_cpu_ranks():
    """zamba2 served with oplib on ``cuda`` from 4 rank threads (each runs
    the contraction kernel's plain version on its CPU shard) matches the
    single-device model on the same backend (whose ``gelu`` is the Stripe
    intrinsic's erf form, where ``torch``'s is tanh); each rank's
    projections went through oplib's ``cuda`` path (its count by rank)."""
    model = api.build_model(api.configs.get("zamba2-2.7b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = _mesh((1, 4))
    placed = sharded.place_params(mesh, params)
    batch = api.make_batch(model.cfg, "prefill", 4, 8, device="cpu")
    old = t_oplib.get_backend()
    try:
        t_oplib.set_backend("cuda")
        t_oplib.launches_by_rank.clear()
        cache = sharded.init_cache(model, mesh, 4, 16)
        slog, cache = sharded.sharded_prefill(model, mesh, placed, batch, cache, timeout=TIMEOUT)
        tok = slog[:, -1:, :model.cfg.vocab].argmax(-1).int()
        slog2, _ = sharded.sharded_decode_step(model, mesh, placed, cache, tok, timeout=TIMEOUT)
        assert sorted(t_oplib.launches_by_rank) == [0, 1, 2, 3]
        one = model.init_cache(4, 16, device="cpu")
        log, one = model.prefill(params, batch, one)
        log2, _ = model.decode_step(params, one, tok)
    finally:
        t_oplib.set_backend(old)
    assert _rel(slog, log) <= LOGIT_RTOL and _rel(slog2, log2) <= LOGIT_RTOL


def _collectives(model, mesh, params, seq: int) -> int:
    batch = api.make_batch(model.cfg, "train", 4, seq, device="cpu")
    with spmd.recording() as calls:
        sharded.sharded_loss_and_grads(model, mesh, params, batch, timeout=TIMEOUT)
    return len([c for c in calls if c[0] != "constrain"])


def test_the_slstm_loop_holds_no_collective():
    """A rank's collectives in a train step of xlstm (an sLSTM block among
    its two) are as many at 16 tokens as at 4: none sits in the time
    loop; and the sLSTM block gathers its three split weights once."""
    model = api.build_model(api.configs.get("xlstm-125m").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = _mesh((2, 2))
    assert _collectives(model, mesh, params, 4) == _collectives(model, mesh, params, 16)


def test_an_unsupported_family_raises():
    model = api.build_model(api.configs.get("llama3-8b").scaled())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    model.cfg = dataclasses.replace(model.cfg, family="rnn")
    with pytest.raises(NotImplementedError, match="rnn"):
        sharded.sharded_loss(model, _mesh((2, 4)), params,
                             api.make_batch(model.cfg, "train", 8, 8, device="cpu"))


# ------------------------------------------------------- restore(shardings=)
def test_restore_a_hybrid_tree_onto_another_mesh_is_bit_equal(tmp_path):
    model = api.build_model(api.configs.get("zamba2-2.7b").scaled(dtype="bfloat16"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["mamba"]["in_proj"].ndim == 4          # (groups, per_group, d, cols)
    state = adamw.init_state(params)
    src, dst = _mesh((2, 4)), _mesh((1, 4))
    t_ckpt.save(str(tmp_path), 3, {"params": sharded.place_params(src, params),
                                   "opt_state": sharded.place_opt_state(src, state)})
    sh = t_shd.make_sharding(dst, t_shd.param_specs(params, dict(dst.shape)))
    step, out = t_ckpt.restore(str(tmp_path), {"params": params}, shardings={"params": sh})
    assert step == 3
    assert out["params"]["mamba"]["in_proj"].spec == spmd.P(None, None, None, "model")
    for leaf in T.leaves(out["params"]):
        assert isinstance(leaf, spmd.Placed) and leaf.mesh is dst
    for a, b in zip(T.leaves(t_shd.assemble(out["params"])), T.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
