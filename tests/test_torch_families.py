"""The port's hybrid, ssm and audio families (zamba2-2.7b, xlstm-125m,
seamless-m4t-large-v2) against the JAX package's, on the CPU.

* ``loss``, ``prefill`` and two ``decode_step``s of each scaled config
  (as ``tests/test_arch_smoke.py`` scales them), weights from the
  reference's ``init_params`` carried over with ``params_from_jax``, in
  float32: the logits, the loss and every leaf of the cache within 1e-4
  of the largest.  The port's ``torch`` backend is held against the
  reference's ``jnp`` backend; its ``cuda`` backend (the contraction
  kernel's plain version on CPU tensors) against the reference's kernel
  backend in interpret mode, because the two kernel backends share the
  Stripe ``gelu`` intrinsic (the exact erf form) where the einsum
  backends use the tanh form (zamba2's gelu GLU).  seamless's relu2 MLP
  has no Tile intrinsic: under the kernel backends both packages raise
  (ROADMAP C9).
* prefill then decode equals the full forward (``test_arch_smoke``'s
  identity, rtol and atol 2e-3).
* ``params_from_jax`` keeps the three trees, ``init_cache`` gives the
  reference's cache tree, and ``Model.init`` draws the reference's tree,
  on the card unless asked for the CPU.
* ``ServingEngine`` refuses the three families, pointing to
  ``WaveEngine``.
* every projection of zamba2-2.7b and xlstm-125m at full width, in bf16,
  at the wave's prefill rows (4 x 100) and decode rows (4), lowers under
  ``oplib``'s ``cuda`` backend to one unit on the contraction kernel:
  ``tiled`` on wgmma at 400 rows, ``skinny`` at 4 (compiled only: no
  tensors).
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

from repro_torch import api  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402

FAMILIES = ["zamba2-2.7b", "xlstm-125m", "seamless-m4t-large-v2"]
# the reference's backend each port backend is held against
TWIN = {"torch": "jnp", "cuda": "pallas_interpret"}


@pytest.fixture
def backends():
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


def _get(tree, path):
    """The leaf of a torch tree (dicts and lists) at a JAX tree path."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _assert_tree(got, want, rtol, what):
    """Every leaf of the reference's tree ``want`` against the port's."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == sum(1 for _ in _leaves(got)), what
    for path, leaf in flat:
        _assert_close(_get(got, path), leaf, rtol, f"{what} {jax.tree_util.keystr(path)}")


def _models(name):
    jcfg, tcfg = j_configs.get(name).scaled(), api.configs.get(name).scaled()
    jm, tm = j_build(jcfg), api.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _models(name) for name in FAMILIES}


def _batch(cfg, kind, b, s, seed):
    return j_batch(cfg, kind, b, s, seed=seed), api.make_batch(cfg, kind, b, s, seed=seed,
                                                               device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_prefill_decode_match_reference(models, name, backend, backends):
    jm, jp, tm, tp = models[name]
    jb, tb = _batch(tm.cfg, "train", 2, 16, seed=1)
    j_oplib.set_backend(TWIN[backend])
    t_oplib.set_backend(backend)
    if backend == "cuda" and tm.cfg.act == "relu2":
        # ROADMAP C9: the Tile text has no relu2, in either package
        for m, p, b in ((jm, jp, jb), (tm, tp, tb)):
            with pytest.raises(ValueError, match="unknown intrinsic 'relu2'"):
                m.loss(p, b, remat=False)
        return

    jl, jmet = jm.loss(jp, jb, remat=False)
    tl, tmet = tm.loss(tp, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)

    jb, tb = _batch(tm.cfg, "prefill", 2, 12, seed=3)
    jlog, jc = jm.prefill(jp, jb, jm.init_cache(2, 32))
    tlog, tc = tm.prefill(tp, tb, tm.init_cache(2, 32, device="cpu"))
    _assert_close(tlog, jlog, 1e-4, f"{name} prefill logits")
    _assert_tree(tc, jc, 1e-4, f"{name} prefill cache")
    tok = np.array([[7], [11]], np.int32)
    for step in range(2):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok + step))
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok + step))
        _assert_close(tlog, jlog, 1e-4, f"{name} decode {step} logits")
        _assert_tree(tc, jc, 1e-4, f"{name} decode {step} cache")


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode_matches_full_forward(models, name):
    """Prefill s tokens then decode one more == prefill over s + 1 tokens
    (seamless: the same frames for the encoder in both)."""
    _jm, _jp, tm, tp = models[name]
    b, s = 2, 12
    full = api.make_batch(tm.cfg, "prefill", b, s + 1, seed=3, device="cpu")
    logits_full, _ = tm.prefill(tp, full, tm.init_cache(b, 32, device="cpu"))
    part = {k: (v[:, :s] if k in ("tokens", "labels") else v) for k, v in full.items()}
    _, cache = tm.prefill(tp, part, tm.init_cache(b, 32, device="cpu"))
    logits_dec, _ = tm.decode_step(tp, cache, full["tokens"][:, s: s + 1])
    np.testing.assert_allclose(_np(logits_dec[:, -1]), _np(logits_full[:, -1]),
                               rtol=2e-3, atol=2e-3)


def _assert_same_tree(got, want, what, device="cpu"):
    """Same keys, shapes and types as the reference's tree ``want``."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == sum(1 for _ in _leaves(got)), what
    for path, leaf in flat:
        t = _get(got, path)
        assert tuple(t.shape) == tuple(leaf.shape), (what, jax.tree_util.keystr(path))
        assert str(t.dtype) == f"torch.{jnp.dtype(leaf.dtype)}", (what, path)
        assert t.device.type == device, (what, path)


def test_params_carry_over_the_three_trees(models):
    """``params_from_jax`` keeps the hybrid's doubly stacked ``mamba``,
    xLSTM's ``layer_{i}`` dicts and the encoder-decoder's stacked
    ``encoder`` and ``decoder``, every leaf's values unchanged."""
    for name in FAMILIES:
        _jm, jp, _tm, tp = models[name]
        _assert_same_tree(tp, jp, name)
        _assert_tree(tp, jp, 0.0, name)
    cfg = models["zamba2-2.7b"][2].cfg
    groups = -(-cfg.n_layers // cfg.hybrid.shared_attn_every)
    mamba = models["zamba2-2.7b"][3]["mamba"]
    assert mamba["in_proj"].shape[:2] == (groups, cfg.hybrid.shared_attn_every)
    assert mamba["A_log"].dtype == torch.float32
    xl = models["xlstm-125m"][3]
    assert set(k for k in xl if k.startswith("layer_")) == {f"layer_{i}" for i in range(2)}
    assert "r_gates" in xl["layer_1"]["core"] and "wq" in xl["layer_0"]["core"]
    _jm, _jp, tm, ed = models["seamless-m4t-large-v2"]
    assert ed["encoder"]["attn"]["wq"].shape[0] == tm.cfg.n_enc_layers
    assert "cross_attn" in ed["decoder"]


@pytest.mark.parametrize("name", FAMILIES)
def test_init_cache_gives_the_reference_tree(models, name):
    jm, _jp, tm, _tp = models[name]
    _assert_same_tree(tm.init_cache(3, 24, device="cpu"), jm.init_cache(3, 24), name)
    _assert_tree(tm.init_cache(3, 24, device="cpu"), jm.init_cache(3, 24), 0.0, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_draws_the_reference_tree_and_defaults_to_the_card(name):
    """``Model.init`` draws the reference's tree (keys, shapes, types)
    onto the card unless the caller passes ``device="cpu"``."""
    jcfg, tcfg = j_configs.get(name).scaled(), api.configs.get(name).scaled()
    want = jax.eval_shape(j_build(jcfg).init, jax.random.PRNGKey(0))
    tm = api.build_model(tcfg)
    _assert_same_tree(tm.init(torch.Generator().manual_seed(0), device="cpu"), want, name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.init(torch.Generator().manual_seed(0))
    else:
        assert tm.init(torch.Generator().manual_seed(0))["embed"].is_cuda


def test_serving_engine_sends_the_three_families_to_the_wave(models):
    """The continuous-batching engine serves the dense family only; the
    hybrid, ssm and audio models are refused with the reference's
    pointer to ``WaveEngine``."""
    for name in FAMILIES:
        with pytest.raises(ValueError, match="WaveEngine"):
            api.ServingEngine(models[name][2], api.EngineConfig(slots=2, max_len=32,
                                                                device="cpu"))


# (k, n, act) of every oplib projection at full width
PROJECTIONS = {
    # Mamba2 in_proj (2 * 5120 + 2 * 64 + 80 = 10448, ragged) and out_proj;
    # the shared block's q, k, v, o; its GLU MLP's gate (gelu), up, down
    "zamba2-2.7b": [(2560, 10448, None), (5120, 2560, None), (2560, 2560, None),
                    (2560, 10240, "gelu"), (2560, 10240, None), (10240, 2560, None)],
    # mLSTM up_proj (and sLSTM w_gates), wq / wk / wv, down_proj; sLSTM
    # w_up and w_down
    "xlstm-125m": [(768, 3072, None), (1536, 1536, None), (1536, 768, None),
                   (768, 2048, None), (1024, 768, None)],
}
LOWERING = [(name, m, k, n, act) for name, ops in PROJECTIONS.items() for k, n, act in ops
            for m in (400, 4)]


@pytest.mark.parametrize("name,m,k,n,act", LOWERING,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}{'-' + c[4] if c[4] else ''}"
                              for c in LOWERING])
def test_full_width_projections_lower_to_one_launch(name, m, k, n, act):
    op = t_oplib._compiled_linear(m, k, n, "bfloat16", "float32", act, False, "cuda")
    assert set(op.block_backends.values()) == {"cuda"} and not op.block_reasons
    fns = [fn for _u, _kind, unit_fns in op.cuda_fn.steps for fn in unit_fns]
    assert len(fns) == 1 and fns[0].out_shape == (m, n)
    want = "tiled" if m == 400 else "skinny"
    assert K.plan_path(fns[0].plan) == want
    if want == "tiled":
        assert K.gemm_view(fns[0].plan).mma == "wgmma"


def test_the_projection_list_covers_the_models(backends):
    """Every ``oplib.linear`` that a full-width zamba2-2.7b and xlstm-125m
    layer calls is in ``PROJECTIONS`` (recorded from a run of 2-layer
    models at full width, with a small vocabulary, on a few bf16 tokens,
    ``torch`` backend)."""
    from repro_torch.nn import core as t_core

    t_oplib.set_backend("torch")
    real = t_core.linear
    for name, ops in PROJECTIONS.items():
        cfg = api.configs.get(name)
        cfg = dataclasses.replace(
            cfg, n_layers=2, vocab=256,
            **({"hybrid": dataclasses.replace(cfg.hybrid, shared_attn_every=2)}
               if cfg.hybrid else {"xlstm": dataclasses.replace(cfg.xlstm, slstm_at=(1,))}))
        tm = api.build_model(cfg)
        params = tm.init(torch.Generator().manual_seed(0), device="cpu")
        seen = set()

        def recording(x, w, bias=None, act=None, seen=seen):
            seen.add((w.shape[0], w.shape[1], act))
            return real(x, w, bias, act)

        mods = [__import__(f"repro_torch.nn.{m}", fromlist=["linear"])
                for m in ("ssm", "xlstm", "attention", "core")]
        try:
            for mod in mods:
                mod.linear = recording
            batch = api.make_batch(cfg, "train", 1, 3, device="cpu")
            tm.loss(params, batch)
        finally:
            for mod in mods:
                mod.linear = real
        assert seen == set(ops), name
