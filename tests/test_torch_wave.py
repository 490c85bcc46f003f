"""The port's wave engine against the JAX package's, on the CPU.

The same numpy weights (the JAX package's ``init_params``, carried over
with ``params_from_jax``) and the same requests go through the JAX
``WaveEngine`` (``jax.jit`` of the model, oplib on ``jnp``) and the
port's ``WaveEngine(device="cpu")`` (eager, oplib on ``torch`` or on
``cuda``, whose kernels run their plain versions on CPU tensors), for a
scaled llama3-8b, qwen3-moe-30b-a3b and internvl2-26b (zero patches in
front of every prompt): prompts of mixed lengths, left-padded to each
wave's longest, 2 slots.  Greedy tokens must be identical (float32), and
the bucket records (``compile_log``: one per cold (slots, prompt length);
``cache_stats``: hits and misses) the same.  The port's batch-1 wave
gives the port's ``ServingEngine`` tokens, as the reference's serving
tests use its wave as the dense baseline.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import oplib as j_oplib  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import WaveEngine as JWave  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import oplib as t_oplib  # noqa: E402

NAMES = ["llama3-8b", "qwen3-moe-30b-a3b", "internvl2-26b"]
# waves of 2: prompt lengths 11, 11 (a warm bucket), 17
PLENS = [5, 11, 3, 11, 17, 8]
SLOTS, MAX_LEN, NEW = 2, 48, 6


@pytest.fixture
def backends():
    old = (j_oplib.get_backend(), t_oplib.get_backend())
    yield
    j_oplib.set_backend(old[0])
    t_oplib.set_backend(old[1])


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in NAMES:
        jm = j_build(j_configs.get(name).scaled())
        jp = jm.init(jax.random.PRNGKey(0))
        tm = api.build_model(api.configs.get(name).scaled())
        out[name] = jm, jp, tm, api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return out


def _prompts(vocab, plens=PLENS, seed=3):
    r = np.random.RandomState(seed)
    return [r.randint(1, vocab, size=p).astype(np.int32) for p in plens]


def _run(engine, request, sampling, params, prompts, new=NEW):
    for i, p in enumerate(prompts):
        engine.submit(request(uid=i, prompt=p.copy(), sampling=sampling(max_new_tokens=new)))
    done = engine.run(params, max_steps=4096)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    assert all(r.done and len(r.out_tokens) == new for r in done)
    return {r.uid: list(r.out_tokens) for r in done}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", NAMES)
def test_wave_tokens_and_buckets_match_reference(models, name, backend, backends):
    jm, jp, tm, tp = models[name]
    j_oplib.set_backend("jnp")
    t_oplib.set_backend(backend)
    prompts = _prompts(tm.cfg.vocab)
    je = JWave(jm, SLOTS, MAX_LEN)
    te = api.WaveEngine(tm, SLOTS, MAX_LEN, device="cpu")
    want = _run(je, JRequest, JSampling, jp, prompts)
    got = _run(te, api.Request, api.SamplingParams, tp, prompts)
    assert got == want
    shapes = [(r["slots"], r["plen"]) for r in te.compile_log()]
    assert shapes == [(r["slots"], r["plen"]) for r in je.compile_log()] == [(2, 11), (2, 17)]
    assert all(r["first_call_s"] > 0 for r in te.compile_log())
    for field in ("hits", "misses", "puts"):
        assert getattr(te.cache_stats(), field) == getattr(je.cache_stats(), field), field
    assert (te.cache_stats().hits, te.cache_stats().misses) == (1, 2)


def test_wave_stops_at_eos_and_pads_the_last_wave(models):
    """A request whose greedy token is its ``eos_id`` finishes there (the
    wave runs on for the others), and a wave of one request fills the
    other slot with a copy of its prompt, as the reference does."""
    jm, jp, tm, tp = models["qwen3-moe-30b-a3b"]
    prompts = _prompts(tm.cfg.vocab, [7, 12, 9])
    free = _run(api.WaveEngine(tm, SLOTS, MAX_LEN, device="cpu"), api.Request,
                api.SamplingParams, tp, prompts)
    eos = free[0][2]
    out = {}
    for eng, req, smp, params in ((JWave(jm, SLOTS, MAX_LEN), JRequest, JSampling, jp),
                                  (api.WaveEngine(tm, SLOTS, MAX_LEN, device="cpu"),
                                   api.Request, api.SamplingParams, tp)):
        for i, p in enumerate(prompts):
            eng.submit(req(uid=i, prompt=p.copy(),
                           sampling=smp(max_new_tokens=NEW, eos_id=eos if i == 0 else -1)))
        out[eng.__class__.__module__] = {r.uid: list(r.out_tokens)
                                         for r in eng.run(params, max_steps=4096)}
    got, want = out["repro_torch.serving.wave"], out["repro.serving.wave"]
    assert got == want
    assert got[0] == free[0][: free[0].index(eos) + 1]
    assert got[1] == free[1] and got[2] == free[2]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batch1_wave_matches_the_serving_engine(models, backend):
    """``tests/test_serving_engine.py::_dense_reference`` on the port: the
    batch-1 wave (one request at a time, no cross-request padding) gives
    the continuous-batching engine's greedy tokens."""
    _jm, _jp, tm, tp = models["llama3-8b"]
    prompts = _prompts(tm.cfg.vocab, [3, 8, 13, 21, 32, 5])
    want = {}
    for uid, p in enumerate(prompts):
        ref = api.WaveEngine(tm, 1, MAX_LEN, device="cpu")
        ref.submit(api.Request(uid=uid, prompt=p.copy(),
                               sampling=api.SamplingParams(max_new_tokens=7)))
        want[uid] = ref.run(tp, max_steps=4096)[0].out_tokens
    eng = api.ServingEngine(tm, api.EngineConfig(slots=3, max_len=MAX_LEN, page_size=8,
                                                 device="cpu", backend=backend))
    got = _run(eng, api.Request, api.SamplingParams, tp, prompts, new=7)
    eng.close()
    assert got == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: device='cuda' works")
def test_wave_on_cuda_without_a_card_raises(models):
    _jm, _jp, tm, _tp = models["llama3-8b"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.WaveEngine(tm, SLOTS, MAX_LEN)


def test_serving_engine_sends_other_families_to_the_wave(models):
    """The continuous-batching engine serves the dense family only; a MoE
    or VLM model is refused with the reference's pointer to WaveEngine."""
    for name in ("qwen3-moe-30b-a3b", "internvl2-26b"):
        with pytest.raises(ValueError, match="WaveEngine"):
            api.ServingEngine(models[name][2], api.EngineConfig(slots=2, max_len=32,
                                                                device="cpu"))
