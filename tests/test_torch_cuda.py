"""Tests that need an NVIDIA card: the CUDA contraction kernel against its
plain PyTorch version.  They skip without a card.  On a machine with one
(and no JAX), run them alone, without the JAX package's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import lower_cuda as LC  # noqa: E402
from repro_torch.core.driver import stripe_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.kernels import contraction as K  # noqa: E402
from repro_torch.kernels.stripe_matmul import matmul, matmul_ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _programs():
    chain = TileProgram("chain")
    chain.input("A", (16, 12)); chain.input("B", (12, 24)); chain.input("b", (24,))
    chain.temp("T", (16, 24)); chain.temp("U", (16, 24)); chain.output("G", (16, 24))
    chain.op("T[i, j] += A[i, c] * B[c, j]", name="mm1")
    chain.op("U[i, j] = T[i, j] + b[j]", name="bias")
    chain.op("G[i, j] = gelu(U[i, j])", name="act")
    pro = TileProgram("pro")
    pro.input("X", (16, 12)); pro.input("W", (12, 24))
    pro.temp("X2", (16, 12)); pro.output("O", (16, 24))
    pro.op("X2[i, c] = gelu(X[i, c])", name="pre")
    pro.op("O[i, j] += X2[i, c] * W[c, j]", name="mm")
    gqa = TileProgram("scores")
    gqa.input("Q", (3, 2, 2, 16)); gqa.input("K", (3, 40, 2, 16)); gqa.output("S", (3, 2, 2, 40))
    gqa.op("S[b, k, g, t] += Q[b, k, g, d] * K[b, t, k, d]", name="scores")
    return {"chain": chain, "prologue": pro, "scores": gqa}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", ["h100", "tpu_v5e", "cpu_test"])
@pytest.mark.parametrize("name", ["chain", "prologue", "scores"])
def test_kernel_matches_plain_on_the_card(name, hw):
    _card()
    prog = _programs()[name].build()
    c = stripe_jit(prog, get_config(hw), "cuda",
                   cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    rng = np.random.RandomState(7)
    env = {k: torch.from_numpy(rng.randn(*prog.buffers[k].shape).astype(np.float32)).cuda()
           for k in prog.inputs}
    before = K.launches
    for _unit, kind, fns in c._fn.steps:
        if kind != "cuda":
            env.update(fns(env))
            continue
        for fn in fns:
            got, want = fn(env), fn.plain(env)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            env[fn.out_buf] = LC._place(env, prog.buffers[fn.out_buf], fn, got)
    assert K.launches > before


@pytest.mark.cuda
def test_stripe_matmul_kernel_on_the_card():
    _card()
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(64, 96).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.randn(96, 32).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(32).astype(np.float32)).cuda()
    before = K.launches
    got = matmul(x, w, b, act="silu")
    assert K.launches == before + 1
    torch.testing.assert_close(got, matmul_ref(x, w, b, act="silu"), rtol=1e-5, atol=1e-5)
