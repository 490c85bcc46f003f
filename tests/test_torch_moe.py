"""The port's LM family (dense, moe, vlm) and its configs against the JAX
package's, on the CPU.

* ``nn.moe.moe_apply`` against ``repro.nn.moe.moe_apply`` at
  qwen3-moe-30b-a3b's and dbrx-132b's scaled configs, float32, the same
  numpy weights (``params_from_jax``): ``out`` and ``aux`` within 1e-5 of
  the largest output (float32 sums of at most k = 2 expert outputs and a
  d-term product, taken in the same order on the CPU).  Also with a
  capacity small enough that tokens overflow, and with relu2 (the non-GLU
  branch); a numpy dispatch written from the routing rule alone gives
  the kept (token, choice) pairs, and both packages must drop exactly
  the others.
* ``loss``, ``prefill`` and ``decode_step`` of the seven lm-family
  configs, scaled as ``tests/test_arch_smoke.py`` scales them, against
  the reference's ``jnp`` backend under the port's ``torch`` and ``cuda``
  backends (the contraction kernel's plain version on CPU tensors):
  float32 within 1e-4 of the largest logit (and of the loss), the KV
  caches the same way.  nemotron-4-15b's relu2 MLP has no Tile intrinsic:
  under the kernel backends both packages raise (ROADMAP C9).
* prefill then decode equals the full forward (``test_arch_smoke``'s
  identity, rtol and atol 2e-3), MoE with ``capacity_factor =
  n_experts``, as the reference's test runs it.
* every config equals the reference's (``dataclasses.asdict``, field by
  field; the fields the port alone has, those of the layered family, the
  shared expert, the Mamba2 conv bias and the norms' eps, stay at their
  defaults, which are the reference's semantics), and the port's
  registry passes the reference's assignment table and parameter count
  bounds.
* ``Model.init`` puts the parameters on the card unless asked for the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import oplib as j_oplib  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.models.build import make_batch as j_batch  # noqa: E402
from repro.nn import moe as j_moe  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402

LM_FAMILY = ["llama3-8b", "qwen3-4b", "chatglm3-6b", "nemotron-4-15b", "qwen3-moe-30b-a3b",
             "dbrx-132b", "internvl2-26b"]
MOE = ["qwen3-moe-30b-a3b", "dbrx-132b"]


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


def _assert_close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(scale, 1.0), f"{what}: max error {err:.3e} (scale {scale:.3e})"


def _cfgs(name, **kw):
    return j_configs.get(name).scaled(**kw), api.configs.get(name).scaled(**kw)


# ------------------------------------------------------------------- moe
def _np_dispatch(p, x, cfg, idx=None):
    """The capacity dispatch written from its rule alone, in numpy: each
    (token, choice), token-major and choice-minor, takes the next free
    row of its expert while the expert has fewer than ``cap``; ``idx``
    (t, k) replaces the router's top-k.  Returns the output and the kept
    mask (t, k)."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    cap = max(int(np.ceil(cfg.moe.capacity_factor * t * k / e)), 4)
    xt = x.reshape(t, d).astype(np.float64)
    logits = xt @ np.asarray(p["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if idx is None:
        idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= gates.sum(-1, keepdims=True)
    used = np.zeros(e, int)
    keep = np.zeros((t, k), bool)
    out = np.zeros((t, d))
    for i in range(t):
        for j in range(k):
            ex = idx[i, j]
            if used[ex] < cap:
                used[ex] += 1
                keep[i, j] = True
                w = {n: np.asarray(p[n][ex], np.float64) for n in ("w_gate", "w_up", "w_down")}
                if cfg.act.endswith("_glu"):
                    g = xt[i] @ w["w_gate"]
                    hid = g / (1.0 + np.exp(-g)) * (xt[i] @ w["w_up"])
                else:
                    hid = np.square(np.maximum(xt[i] @ w["w_up"], 0.0))
                out[i] += gates[i, j] * (hid @ w["w_down"])
    return out.reshape(b, s, d), keep


MOE_CASES = [(name, kw) for name in MOE for kw in ({}, {"capacity_factor": 0.25})] + \
    [("qwen3-moe-30b-a3b", {"act": "relu2"})]


@pytest.mark.parametrize("name,kw", MOE_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in MOE_CASES])
def test_moe_apply_matches_reference(name, kw):
    jcfg, tcfg = _cfgs(name, act=kw.get("act", j_configs.get(name).act))
    if "capacity_factor" in kw:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=kw["capacity_factor"])) for c in (jcfg, tcfg))
    jp = j_moe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["router"].dtype == torch.float32 and tp["w_gate"].shape[0] == jcfg.moe.n_experts
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(np.float32)
    jo, ja = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    to, ta = t_moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert to.shape == x.shape and to.dtype == torch.float32
    _assert_close(to, jo, 1e-5, f"{name} out")
    assert float(ta) == pytest.approx(float(ja), rel=1e-5, abs=1e-5)

    want, keep = _np_dispatch(jp, x, jcfg)
    dropped = ~keep
    if "capacity_factor" in kw:
        assert dropped.all(-1).any(), "the small capacity must drop every choice of a token"
    # both packages drop exactly these pairs: their outputs are the kept
    # pairs' sum, and a token with every choice dropped is 0
    for got in (_np(to), _np(jo)):
        _assert_close(got, want, 1e-5, f"{name} against the numpy dispatch")
        gone = dropped.all(-1).reshape(2, 16)
        assert not np.abs(got[gone]).any()


def test_moe_apply_takes_given_experts(monkeypatch):
    """``moe_apply`` takes its experts from the module's ``route``, looked
    up at each call, so a harness that patches ``route`` replays another
    run's routing: the router's own choice gives the output bit for bit,
    and another choice (each token's 2nd to (k+1)-th experts) the numpy
    dispatch of that choice, gated by this call's probabilities."""
    _jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    jp = j_moe.moe_init(jax.random.PRNGKey(0), _jcfg, jnp.float32)
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32))
    real = t_moe.route
    probs, own = real(tp, x, cfg)
    assert own.shape == (32, cfg.moe.top_k)
    out, aux = t_moe.moe_apply(tp, x, cfg)

    def replaying(experts):
        return lambda p, xt, c: (real(p, xt, c)[0], experts)

    monkeypatch.setattr(t_moe, "route", replaying(own))
    again, aux2 = t_moe.moe_apply(tp, x, cfg)
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    other = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).indices[:, 1:]
    monkeypatch.setattr(t_moe, "route", replaying(other))
    got, _ = t_moe.moe_apply(tp, x, cfg)
    want, _keep = _np_dispatch(jp, x.numpy(), _jcfg, idx=other.numpy())
    _assert_close(got, want, 1e-5, "given experts")
    assert not torch.allclose(got, out)


# --------------------------------------------------------------- models
def _models(name):
    jcfg, tcfg = _cfgs(name)
    jm, tm = j_build(jcfg), api.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return {name: _models(name) for name in LM_FAMILY}


def _batch(cfg, kind, b, s, seed):
    return j_batch(cfg, kind, b, s, seed=seed), api.make_batch(cfg, kind, b, s, seed=seed,
                                                               device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", LM_FAMILY)
def test_lm_family_loss_prefill_decode_match_reference(models, name, backend, backends):
    jm, jp, tm, tp = models[name]
    jb, tb = _batch(tm.cfg, "train", 2, 16, seed=1)
    t_oplib.set_backend(backend)
    if backend == "cuda" and tm.cfg.act == "relu2":
        # ROADMAP C9: the Tile text has no relu2, so nemotron's MLP cannot
        # go through oplib's kernel backend, in either package
        j_oplib.set_backend("pallas_interpret")
        for m, p, b in ((jm, jp, jb), (tm, tp, tb)):
            with pytest.raises(ValueError, match="unknown intrinsic 'relu2'"):
                m.loss(p, b, remat=False)
        return
    j_oplib.set_backend("jnp")

    jl, jmet = jm.loss(jp, jb, remat=False)
    tl, tmet = tm.loss(tp, tb)
    for key in ("loss", "aux"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-4, abs=1e-4), key
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    assert (float(tmet["aux"]) > 0.5) == bool(tm.cfg.moe)

    jb, tb = _batch(tm.cfg, "prefill", 2, 12, seed=3)
    jlog, jc = jm.prefill(jp, jb, jm.init_cache(2, 32))
    tlog, tc = tm.prefill(tp, tb, tm.init_cache(2, 32, device="cpu"))
    _assert_close(tlog, jlog, 1e-4, f"{name} prefill logits")
    for k in ("k", "v", "pos"):
        _assert_close(tc[k], jc[k], 1e-4, f"{name} prefill cache {k}")
    tok = np.array([[7], [11]], np.int32)
    for step in range(2):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok + step))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok + step))
        _assert_close(tlog, jlog, 1e-4, f"{name} decode {step} logits")
        for k in ("k", "v", "pos"):
            _assert_close(tc[k], jc[k], 1e-4, f"{name} decode {step} cache {k}")


@pytest.mark.parametrize("name", LM_FAMILY)
def test_prefill_then_decode_matches_full_forward(models, name):
    """Prefill s tokens then decode one more == prefill over s + 1 tokens
    (the VLM's patches in front of both).  MoE runs with ``capacity_factor
    = n_experts``: with drops, the two token counts drop different
    tokens (see ``tests/test_arch_smoke.py``)."""
    _jm, _jp, tm, tp = models[name]
    cfg = tm.cfg
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    tm = api.build_model(cfg)
    b, s = 2, 12
    full = api.make_batch(cfg, "prefill", b, s + 1, seed=3, device="cpu")
    logits_full, _ = tm.prefill(tp, full, tm.init_cache(b, 32, device="cpu"))
    part = {k: (v[:, :s] if k in ("tokens", "labels") else v) for k, v in full.items()}
    _, cache = tm.prefill(tp, part, tm.init_cache(b, 32, device="cpu"))
    logits_dec, _ = tm.decode_step(tp, cache, full["tokens"][:, s: s + 1])
    np.testing.assert_allclose(_np(logits_dec[:, -1]), _np(logits_full[:, -1]),
                               rtol=2e-3, atol=2e-3)


def test_moe_and_vlm_params_carry_over_from_the_reference(models):
    """``params_from_jax`` keeps the reference's tree: the router float32,
    the experts stacked on a leading axis under the layer axis, and the
    VLM's ``patch_proj``."""
    for name in ("qwen3-moe-30b-a3b", "internvl2-26b"):
        jm, jp, tm, tp = models[name]
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(flat_j) == sum(1 for _ in _leaves(tp))
        for path, leaf in flat_j:
            keys = [getattr(k, "key", None) for k in path]
            got = tp
            for k in keys:
                got = got[k]
            assert tuple(got.shape) == tuple(leaf.shape), keys
            assert str(got.dtype) == f"torch.{leaf.dtype}", keys
    moe = models["qwen3-moe-30b-a3b"][3]["blocks"]["moe"]
    cfg = models["qwen3-moe-30b-a3b"][2].cfg
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_gate"].shape) == (cfg.n_layers, cfg.moe.n_experts, cfg.d_model,
                                          cfg.moe.d_ff_expert)
    assert "patch_proj" in models["internvl2-26b"][3]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_init_draws_the_reference_tree_and_defaults_to_the_card():
    """``Model.init`` draws the reference's tree (same keys, shapes and
    types; a float32 router, ``patch_proj`` for the VLM) onto the card
    unless the caller passes ``device="cpu"``."""
    for name in ("qwen3-moe-30b-a3b", "internvl2-26b", "llama3-8b"):
        jcfg, tcfg = _cfgs(name)
        jp = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
        tm = api.build_model(tcfg)
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(flat_j) == sum(1 for _ in _leaves(tp)), name
        for path, leaf in flat_j:
            got = tp
            for k in path:
                got = got[k.key]
            assert tuple(got.shape) == tuple(leaf.shape) and got.device.type == "cpu", path
            assert str(got.dtype) == f"torch.{leaf.dtype}", path
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tm.init(torch.Generator().manual_seed(0))
        else:
            assert tm.init(torch.Generator().manual_seed(0))["embed"].is_cuda


# --------------------------------------------------------------- configs
def _as_reference(port, ref):
    """``port``'s fields that ``ref`` has, as ``dataclasses.asdict`` gives
    them; each field that the port alone has must hold its default."""
    if not dataclasses.is_dataclass(port):
        return port
    out = {}
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if hasattr(ref, f.name):
            out[f.name] = _as_reference(value, getattr(ref, f.name))
        else:
            assert value == f.default, (type(port).__name__, f.name, value)
    return out


@pytest.mark.parametrize("name", j_configs.names())
def test_config_matches_reference(name):
    t_cfg, j_cfg = api.configs.get(name), j_configs.get(name)
    assert _as_reference(t_cfg, j_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert _as_reference(t_cfg.scaled(), j_cfg.scaled()) == dataclasses.asdict(j_cfg.scaled())


def test_registry_passes_the_reference_assignment_table():
    """The reference's ``test_configs_match_assignment`` and
    ``test_all_archs_build_and_param_counts_sane``, on the port's registry."""
    assert api.configs.names() == j_configs.names()
    rows = {
        "xlstm-125m": (12, 768, 4, 4, 0, 50304),
        "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
        "llama3-8b": (32, 4096, 32, 8, 14336, 128256),
        "qwen3-4b": (36, 2560, 32, 8, 9728, 151936),
        "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 768, 151936),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
        "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
        "zamba2-2.7b": (54, 2560, 32, 32, 10240, 32000),
    }
    get = api.configs.get
    for name, (L, d, h, kv, ff, v) in rows.items():
        cfg = get(name)
        assert cfg.n_layers == L and cfg.d_model == d, name
        assert cfg.n_heads == h and cfg.n_kv_heads == kv, name
        assert cfg.d_ff == ff and cfg.vocab == v, name
        assert cfg.padded_vocab % 16 == 0, name
    assert get("qwen3-moe-30b-a3b").moe.n_experts == 128
    assert get("qwen3-moe-30b-a3b").moe.top_k == 8
    assert get("dbrx-132b").moe.n_experts == 16
    assert get("dbrx-132b").moe.top_k == 4
    assert get("zamba2-2.7b").ssm.d_state == 64
    bounds = {"xlstm-125m": (0.08e9, 0.4e9), "nemotron-4-15b": (12e9, 20e9),
              "chatglm3-6b": (5e9, 9e9), "llama3-8b": (6e9, 10e9), "qwen3-4b": (3e9, 6e9),
              "qwen3-moe-30b-a3b": (25e9, 36e9), "dbrx-132b": (110e9, 150e9),
              "internvl2-26b": (18e9, 30e9), "seamless-m4t-large-v2": (1.5e9, 4e9),
              "zamba2-2.7b": (2e9, 4e9)}
    for name, (lo, hi) in bounds.items():
        assert lo < get(name).param_count() < hi, name
    # every config of the registry builds
    for name in api.configs.names():
        assert api.build_model(get(name)).cfg is get(name)
