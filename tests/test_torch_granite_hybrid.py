"""The layered hybrid (``models/layered.py``, granite-4.0-h-small's
layout) and what it added to the port, on the CPU:

* ``ArchConfig`` built from mappings and lists (a configuration read from
  JSON) equals the one built from dataclasses and tuples, and another
  family refuses the layered family's settings;
* a Mamba2 layer with a conv bias and the configured norm eps: a prefill of 12
  tokens then 4 decode steps equals one forward over the 16, and the
  ``ssm.mixer`` / ``ssm.scan`` spans say what ran;
* a prefill longer than one chunk of the scan by a ragged part equals the
  scan in chunks that divide it;
* the layered model's cache holds KV only for the attention layers and
  Mamba2 state only for the Mamba2 layers, and its prefill then decode
  steps equal one forward, also through ``WaveEngine``; its loss is the
  forward's cross-entropy, and gradients reach the stacked leaves;
* NoPE attention with a configured scale;
* the shared expert adds its GLU's work to ``moe_apply`` and nothing else,
  so a configuration without one runs what it ran before;
* the MoE dispatch's plain version at 72 experts, top-10 (an expert count
  that is not a power of two) against the definition; on the card
  (skipped without one) the kernel against the plain version at the
  extraction cell's prefill and decode shapes.

This file imports nothing of JAX or of the JAX package."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_moe_dispatch import _definition, _routing, _slots  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg  # noqa: E402
from repro_torch.configs.granite_4_0_h_small import CONFIG  # noqa: E402
from repro_torch.core import oplib  # noqa: E402
from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.models import layered  # noqa: E402
from repro_torch.nn import attention as t_attn  # noqa: E402
from repro_torch.nn import core as t_core  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402
from repro_torch.nn import ssm as t_ssm  # noqa: E402
from repro_torch.nn.scan_ops import chunked_gla_torch  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

PATTERN = ("mamba", "attention", "mamba", "mamba")


def _tiny(**kw) -> ArchConfig:
    """granite-4.0-h-small's layout at a tiny width, float32."""
    base = dict(n_layers=len(PATTERN), d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=32, vocab=128, vocab_pad_multiple=32, dtype="float32",
                moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=48),
                ssm=SSMCfg(d_state=16, n_ssm_heads=8, head_dim=16, expand=2, conv_width=4,
                           conv_bias=True),
                layer_types=PATTERN)
    base.update(kw)
    return dataclasses.replace(CONFIG, **base)


@pytest.fixture
def torch_backend():
    old = oplib.get_backend()
    oplib.set_backend("torch")
    yield
    oplib.set_backend(old)


def _randomize(tree, gen):
    """Every leaf drawn anew (biases and scales too, so that each one
    shows), N(0, 0.3^2) around its value."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize(v, gen)
        else:
            v.add_(torch.randn(v.shape, generator=gen) * 0.3)


# ------------------------------------------------------------- configs
def test_arch_config_takes_mappings_and_lists():
    raw = json.loads(json.dumps(dataclasses.asdict(CONFIG)))
    assert isinstance(raw["moe"], dict) and isinstance(raw["layer_types"], list)
    cfg = ArchConfig(**raw)
    assert cfg == CONFIG
    assert isinstance(cfg.moe, MoECfg) and isinstance(cfg.ssm, SSMCfg)
    assert isinstance(cfg.layer_types, tuple) and hash(cfg) == hash(CONFIG)
    assert dataclasses.replace(cfg, n_layers=40) == CONFIG
    xl = api.configs.get("xlstm-125m")
    assert ArchConfig(**json.loads(json.dumps(dataclasses.asdict(xl)))) == xl


@pytest.mark.parametrize("field, value", [
    ("layer_types", ("attention",)), ("embedding_multiplier", 12.0),
    ("residual_multiplier", 0.22), ("logits_scaling", 16.0),
    ("attention_multiplier", 0.0078125), ("norm_eps", 1e-5)])
def test_another_family_refuses_a_layered_setting(field, value):
    """No path of the other families reads these (the LM family's norms
    keep 1e-6; the sharded and paged attention keep 1 / sqrt(head dim)),
    so a value away from the default is refused, not ignored."""
    dense = api.configs.get("llama3-8b")
    assert dataclasses.replace(dense, **{field: getattr(dense, field)}) == dense
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(dense, **{field: value})
    assert getattr(dataclasses.replace(CONFIG, **{field: value}), field) == value


def test_the_configuration_is_granite_4_0_h_small():
    assert [i for i, k in enumerate(CONFIG.layer_types) if k == "attention"] == [5, 15, 25, 35]
    inner, heads, state = t_ssm.mamba2_dims(CONFIG)
    assert (inner, heads, state) == (8192, 128, 128) and CONFIG.padded_vocab == CONFIG.vocab
    params = api.build_model(CONFIG).init(torch.Generator(), device="meta")
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params["blocks"])
    # every leaf of the stacked layers keeps its layer axis (2-D or more)
    assert min(v.dim() for v in leaves) >= 2
    total = sum(v.numel() for v in leaves) + params["embed"].numel()
    assert 32.1e9 < total < 32.3e9 and "unembed" not in params


# --------------------------------------------------------------- Mamba2
def test_mamba2_prefill_then_decode_equals_one_forward(torch_backend):
    cfg = _tiny()
    gen = torch.Generator().manual_seed(1)
    p = t_ssm.mamba2_init(gen, cfg, torch.float32, "cpu")
    _randomize(p, gen)
    assert p["conv_bias"].abs().min() > 0
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    want, _ = t_ssm.mamba2_apply(p, x, cfg)
    state = t_ssm.mamba2_init_state(cfg, 2, torch.float32, "cpu")
    obs_trace.clear()
    obs_trace.enable()
    try:
        outs = [t_ssm.mamba2_apply(p, x[:, :12], cfg, state=state)[0]]
        for i in range(12, 16):
            outs.append(t_ssm.mamba2_apply(p, x[:, i:i + 1], cfg, state=state)[0])
    finally:
        obs_trace.disable()
    got = torch.cat(outs, 1)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # without the bias the output moves: the bias is on the path
    no_bias, _ = t_ssm.mamba2_apply({k: v for k, v in p.items() if k != "conv_bias"}, x, cfg)
    assert (no_bias - want).abs().max() > 1e-2 * want.abs().max()
    spans = obs_trace.spans()
    mixers = [s for s in spans if s.name == "ssm.mixer"]
    scans = [s for s in spans if s.name == "ssm.scan"]
    assert [(s.attrs["rows"], s.attrs["width"], s.attrs["tokens"], s.attrs["kind"])
            for s in mixers] == [(2, 12, 24, "prefill")] + [(2, 1, 2, "decode")] * 4
    assert len(scans) == 5 and all(s.parent == "ssm.mixer" for s in scans)
    assert all(s.device_dur is None for s in mixers + scans)       # off the card


def test_a_ragged_prefill_equals_the_scan_in_chunks_that_divide_it(torch_backend):
    """300 steps with chunk 256: padded inside to 512, against chunks of
    100 (which divide 300), in float64, where the padding changes nothing
    but rounding; then a Mamba2 layer's float32 prefill of 300 tokens
    against 300 one-token steps, its outputs and its final state."""
    g = torch.Generator().manual_seed(2)
    b, h, s, n, hd = 1, 8, 300, 16, 16
    q, k = (torch.randn(b, h, s, n, generator=g, dtype=torch.float64) for _ in range(2))
    v = torch.randn(b, h, s, hd, generator=g, dtype=torch.float64)
    ld = -torch.rand(b, h, s, generator=g, dtype=torch.float64)
    gain = torch.rand(b, h, s, generator=g, dtype=torch.float64)
    got = t_ssm._chunked_scan(q, k, v, ld, gain, 256)
    want = chunked_gla_torch(q, k, v, ld, gain, chunk=100, normalize=False)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()

    cfg = _tiny()
    p = t_ssm.mamba2_init(g, cfg, torch.float32, "cpu")
    _randomize(p, g)
    x = torch.randn(1, s, cfg.d_model, generator=g) * 0.5
    state = t_ssm.mamba2_init_state(cfg, 1, torch.float32, "cpu")
    got, state = t_ssm.mamba2_apply(p, x, cfg, state=state)
    steps = t_ssm.mamba2_init_state(cfg, 1, torch.float32, "cpu")
    want = torch.cat([t_ssm.mamba2_apply(p, x[:, i:i + 1], cfg, state=steps)[0]
                      for i in range(s)], 1)
    # float32 sums over chunks of 256 against a running state
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    for key in state:
        assert (state[key] - steps[key]).abs().max() <= 1e-4 * (1 + steps[key].abs().max()), key


# -------------------------------------------------------- layered model
def test_the_cache_holds_kv_only_for_attention_layers():
    cfg = _tiny(layer_types=("mamba", "attention", "mamba", "attention"))
    cache = api.build_model(cfg).init_cache(3, 20, device="cpu")
    assert set(cache) == {"attn", "mamba"}
    assert cache["attn"]["k"].shape == (2, 3, 20, cfg.n_kv_heads, cfg.hd)
    assert cache["attn"]["pos"].shape == (2,)
    assert cache["mamba"]["C"].shape == (2, 3, 8, 16, 16)
    assert set(cache["mamba"]) == {"conv", "C", "n"}
    only_mamba = api.build_model(_tiny(n_layers=2, layer_types=("mamba", "mamba")))
    assert set(only_mamba.init_cache(1, 8, device="cpu")) == {"mamba"}
    with pytest.raises(ValueError, match="layer_types"):
        api.build_model(_tiny(n_layers=3)).init_cache(1, 8, device="cpu")


def test_prefill_then_decode_equals_one_forward(torch_backend):
    """With room for every pair in each expert (capacity factor = the
    expert count), so that the calls' capacities drop nothing."""
    cfg = _tiny(moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=48,
                           capacity_factor=8.0))
    model = api.build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    p = model.init(gen, device="cpu")
    _randomize(p["blocks"]["mamba"], gen)
    toks = torch.randint(0, cfg.vocab, (2, 14), generator=gen, dtype=torch.int32)
    cache = model.init_cache(2, 16, device="cpu")
    with torch.no_grad():
        full = layered._logits(p, cfg, layered._forward(p, cfg, layered._embed(p, cfg, toks))[0])
        logits, cache = model.prefill(p, {"tokens": toks[:, :10]}, cache)
        got = [logits[:, -1]]
        for i in range(10, 13):
            logits, cache = model.decode_step(p, cache, toks[:, i:i + 1])
            got.append(logits[:, -1])
    assert cache["attn"]["pos"].tolist() == [13]
    got = torch.stack(got, 1)
    want = full[:, 9:13]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # the multipliers: the logits are the final norm's against the tied
    # table over logits_scaling
    x = layered._forward(p, cfg, layered._embed(p, cfg, toks))[0]
    plain = t_core.unembed(t_core.apply_norm(p["final_norm"], x, "rmsnorm", cfg.norm_eps),
                           p["embed"], True)
    assert torch.allclose(full * cfg.logits_scaling, plain, rtol=1e-5, atol=1e-6)


def test_the_loss_is_the_forwards_cross_entropy(torch_backend):
    cfg = _tiny()
    model = api.build_model(cfg)
    p = model.init(torch.Generator().manual_seed(7), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(7))
    total, parts = model.loss(p, {"tokens": toks, "labels": toks}, remat=True)
    x, aux = layered._forward(p, cfg, layered._embed(p, cfg, toks))
    want = t_core.softmax_xent(layered._logits(p, cfg, x)[:, :-1], toks[:, 1:], cfg.vocab)
    assert torch.allclose(parts["loss"], want) and torch.allclose(total, want + 0.01 * aux)
    p["blocks"]["mamba"]["conv_bias"].requires_grad_(True)
    model.loss(p, {"tokens": toks, "labels": toks}, remat=True)[0].backward()
    assert p["blocks"]["mamba"]["conv_bias"].grad.abs().sum() > 0


def test_the_wave_engine_serves_the_layered_model(torch_backend):
    cfg = _tiny(moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=48,
                           capacity_factor=8.0))
    model = api.build_model(cfg)
    p = model.init(torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab, size=n) for n in (5, 9)]
    eng = api.WaveEngine(model, 2, 16, device="cpu")
    for uid, prompt in enumerate(prompts):
        eng.submit(api.Request(uid=uid, prompt=prompt,
                               sampling=api.SamplingParams(max_new_tokens=4, eos_id=-1)))
    done = sorted(eng.run(p), key=lambda r: r.uid)
    # the same tokens, greedy, from one forward over each left-padded row
    toks = np.zeros((2, 9 + 3), np.int64)
    for i, (prompt, r) in enumerate(zip(prompts, done)):
        toks[i, 9 - len(prompt):9] = prompt
        toks[i, 9:] = r.out_tokens[:3]
    t = torch.from_numpy(toks)
    with torch.no_grad():
        full = layered._logits(p, cfg, layered._forward(p, cfg, layered._embed(p, cfg, t))[0])
    want = full[:, 8:12, : cfg.vocab].argmax(-1)
    assert [r.out_tokens for r in done] == want.tolist()


# ------------------------------------------------------------ attention
def test_nope_attention_with_a_configured_scale(torch_backend):
    cfg = _tiny(rope="none", attention_multiplier=0.3)
    gen = torch.Generator().manual_seed(5)
    p = t_attn.attn_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 7, cfg.d_model, generator=gen)
    got, _ = t_attn.attention(p, x, cfg, causal=True)
    b, s, h, kv, hd = 2, 7, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).view(b, s, h, hd).transpose(1, 2)
    k = (x @ p["wk"]).view(b, s, kv, hd).repeat_interleave(h // kv, 2).transpose(1, 2)
    v = (x @ p["wv"]).view(b, s, kv, hd).repeat_interleave(h // kv, 2).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) * 0.3
    scores = scores.masked_fill(~torch.tril(torch.ones(s, s, dtype=torch.bool)), float("-inf"))
    want = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(b, s, h * hd) @ p["wo"]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert t_attn.softmax_scale(cfg) == 0.3
    assert t_attn.softmax_scale(_tiny(attention_multiplier=0.0)) == 1.0 / 4.0
    # no positions: the same keys at other offsets give the same output,
    # where rotary embeddings would move it
    far = torch.arange(100, 107)[None]
    assert torch.equal(t_attn.attention(p, x, cfg, positions=far)[0], got)
    roped = dataclasses.replace(cfg, rope="full")
    assert not torch.allclose(t_attn.attention(p, x, roped, positions=far)[0],
                              t_attn.attention(p, x, roped)[0])


# ------------------------------------------------------------------ MoE
def _ops(fn, *a):
    """The aten operations ``fn(*a)`` runs, as a multiset."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    seen = Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn(*a)
    return out, seen


def test_the_shared_expert_adds_its_glu_and_nothing_else(torch_backend):
    cfg = _tiny()
    plain = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff_shared=0))
    gen = torch.Generator().manual_seed(6)
    p = t_moe.moe_init(gen, cfg, torch.float32, "cpu")
    assert set(p) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert p["shared"]["w_gate"].shape == (cfg.d_model, 48)
    routed = {k: v for k, v in p.items() if k != "shared"}
    assert set(t_moe.moe_init(gen, plain, torch.float32, "cpu")) == set(routed)
    x = torch.randn(2, 9, cfg.d_model, generator=gen)
    (with_shared, _), ops = _ops(t_moe.moe_apply, p, x, cfg)
    (without, _), ops_plain = _ops(t_moe.moe_apply, routed, x, plain)
    glu, ops_glu = _ops(t_core.mlp_apply, p["shared"], x, cfg.act)
    assert torch.allclose(with_shared, without + glu, rtol=1e-6, atol=1e-6)
    ops_glu["aten.add"] += 1
    assert ops == ops_plain + ops_glu


# --------------------------------------------------------- MoE dispatch
GRANITE_CASES = [(300, 10, 72, 53, 0.0), (300, 10, 72, 53, 4.0), (4, 10, 72, 4, 0.0),
                 (129, 10, 72, 23, 0.0)]
GRANITE_IDS = [f"t{t}-k{k}-e{e}-cap{c}" + ("-skew" if s else "")
               for t, k, e, c, s in GRANITE_CASES]


@pytest.mark.parametrize("t,k,e,cap,skew", GRANITE_CASES, ids=GRANITE_IDS)
def test_plain_dispatch_at_72_experts_is_the_definition(t, k, e, cap, skew):
    eid = _routing(np.random.RandomState(t + k), t, k, e, skew)
    pair_of_slot, dropped = MD.dispatch(eid, e, cap)
    want = _definition(eid, cap, 0, e)
    assert np.array_equal(pair_of_slot.numpy(), want[1])
    assert np.array_equal(_slots(pair_of_slot, t * k, e, cap).numpy(), want[0])
    assert int(dropped) == want[2]


# the extraction cell's wave prefill (4 rows of 2506) and a decode call, at
# the capacity of factor 1.25, and a skewed prefill
CARD_CASES = [(10024, 10, 72, 1741, 0.0), (10024, 10, 72, 1741, 3.0), (4, 10, 72, 4, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,e,cap,skew", CARD_CASES,
                         ids=[f"t{t}-cap{c}" + ("-skew" if s else "")
                              for t, k, e, c, s in CARD_CASES])
def test_kernel_at_72_experts_equals_plain_on_the_card(t, k, e, cap, skew):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    eid = _routing(np.random.RandomState(t + e), t, k, e, skew)
    want = MD.dispatch(eid, e, cap)
    before = MD.launches
    got = MD.dispatch(eid.cuda(), e, cap)
    torch.cuda.synchronize()
    assert MD.launches == before + 2
    for g, w, what in zip(got, want, ("pair_of_slot", "dropped")):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), what
