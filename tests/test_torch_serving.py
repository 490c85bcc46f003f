"""The port's serving engine against the JAX package's, on the CPU.

The same numpy weights (the JAX package's ``init_params``, carried over
with ``params_from_jax``) and the same requests go through the JAX
``ServingEngine(backend="jnp")`` and through the port's engine with
``backend="torch"`` and ``backend="cuda"`` (the kernel's plain version on
CPU tensors): greedy tokens must be identical, first-step logits agree to
rtol 1e-4 (float32, other summation order), and a decode-step fault
replays exactly once with the same recovery events."""
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.reliability import faults as j_faults  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
            head_dim=16, vocab_pad_multiple=16)
PLENS = [5, 11, 3, 17, 8]
GEOM = dict(slots=2, max_len=48, page_size=8)


@pytest.fixture(scope="module")
def jmodel():
    return j_build(j_configs.get("llama3-8b").scaled(**TINY))


@pytest.fixture(scope="module")
def jparams(jmodel):
    return jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _prompts(seed=3):
    r = np.random.RandomState(seed)
    return [r.randint(1, TINY["vocab"], size=p).astype(np.int32) for p in PLENS]


def _serve_jax(jmodel, jparams, new=6, **kw):
    eng = JEngine(jmodel, JConfig(**GEOM, backend="jnp", **kw))
    for i, p in enumerate(_prompts()):
        eng.submit(JRequest(uid=i, prompt=p.copy(), sampling=JSampling(max_new_tokens=new)))
    done = eng.run(jparams, max_steps=4096)
    return {r.uid: list(r.out_tokens) for r in done}, eng


def _serve_port(tparams, backend, new=6, **kw):
    cfg = api.configs.get("llama3-8b").scaled(**TINY)
    eng = api.ServingEngine(api.build_model(cfg),
                            api.EngineConfig(**GEOM, device="cpu", backend=backend, **kw))
    for i, p in enumerate(_prompts()):
        eng.submit(api.Request(uid=i, prompt=p.copy(),
                               sampling=api.SamplingParams(max_new_tokens=new)))
    done = eng.run(tparams, max_steps=4096)
    return {r.uid: list(r.out_tokens) for r in done}, eng


@pytest.fixture(scope="module")
def jax_tokens(jmodel, jparams):
    return _serve_jax(jmodel, jparams)[0]


@pytest.mark.parametrize("backend,hw", [("torch", "h100"), ("cuda", "h100"),
                                        ("cuda", "tpu_v5e")])
def test_greedy_tokens_identical_to_jax_engine(backend, hw, tparams, jax_tokens):
    got, eng = _serve_port(tparams, backend, hw=hw)
    assert got == jax_tokens
    assert all(len(t) == 6 for t in got.values())
    recs = eng.compile_records()
    assert recs, "the engine compiled its block programs"
    for name, rec in recs.items():
        assert rec.backend == backend, name
        if backend == "cuda":
            assert set(rec.block_backends.values()) == {"cuda"}, name
            assert not rec.fallback_reasons(), name


def test_first_step_logits_match(jmodel, jparams, tparams, monkeypatch):
    """The logits of the first decode step (every slot live, their KV pages
    written by the prefills) agree."""
    jlog, tlog = [], []
    j_orig, t_orig = j_lm._logits, t_lm._logits

    def j_spy(p, cfg, x):
        out = j_orig(p, cfg, x)
        jax.debug.callback(lambda v: jlog.append(np.asarray(v)), out)
        return out

    def t_spy(p, cfg, x):
        out = t_orig(p, cfg, x)
        tlog.append(out.detach().numpy().copy())
        return out

    monkeypatch.setattr(j_lm, "_logits", j_spy)
    monkeypatch.setattr(t_lm, "_logits", t_spy)
    _serve_jax(jmodel, jparams, new=2)
    _serve_port(tparams, "cuda", new=2)
    # the JAX engine also logs its compile warm-up prefills: take the first
    # (slots, 1, V) logits of each, the first decode step's
    first = [next(x for x in log if x.shape[0] == GEOM["slots"]) for log in (jlog, tlog)]
    assert first[0].shape == first[1].shape
    np.testing.assert_allclose(first[1], first[0], rtol=1e-4, atol=1e-5)


def test_decode_fault_replays_exactly_once(jmodel, jparams, tparams):
    from repro_torch.reliability import faults as t_faults

    with j_faults.inject(j_faults.fail_nth("serve.decode_step", 3)):
        jtok, jeng = _serve_jax(jmodel, jparams)
    with t_faults.inject(t_faults.fail_nth("serve.decode_step", 3)):
        ttok, teng = _serve_port(tparams, "cuda")
    assert ttok == jtok
    recovery = ("device_step_failed", "requeue", "admit", "finish")
    jev = [(e["event"], e.get("uid")) for e in jeng.events() if e["event"] in recovery]
    tev = [(e["event"], e.get("uid")) for e in teng.events() if e["event"] in recovery]
    assert tev == jev
    assert any(ev == "device_step_failed" for ev, _ in tev)
    assert teng.metrics()["retries"] == jeng.metrics()["retries"] > 0


def test_engine_raises_without_the_card_it_was_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = api.configs.get("llama3-8b").scaled(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.ServingEngine(api.build_model(cfg), api.EngineConfig(**GEOM))


def test_engine_config_defaults_are_the_kernel_path():
    c = api.EngineConfig()
    assert (c.device, c.backend, c.hw) == ("cuda", "cuda", "h100")
    assert not hasattr(c, "interpret")


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        new = ("repro_torch.tune.db", "repro_torch.core.oplib", "repro_torch.obs.__main__",
               "repro_torch.models.build", "repro_torch.nn.attention", "repro_torch.models.lm")
        assert all(m in sys.modules for m in new), [m for m in new if m not in sys.modules]
        print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
    """)
    import os
    from pathlib import Path

    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH", "")) if p))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
