"""The port's Stripe-compiled matmul against the JAX package's oracle, on
the cases of tests/test_kernels.py: the kernel's plain version on the CPU
(tests/test_torch_cuda.py and chip_smoke.py run the kernel on the card)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.stripe_matmul.ref import matmul_ref as j_matmul_ref  # noqa: E402

from repro_torch.kernels.stripe_matmul import matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.stripe_matmul.kernel import build_matmul_kernel, describe_kernel  # noqa: E402


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 384), (64, 96, 32), (512, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stripe_matmul_shapes(m, k, n, dtype):
    rng = np.random.RandomState(m + n)
    x, w = rng.randn(m, k), rng.randn(k, n)
    want = j_matmul_ref(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = matmul(_torch(x, dtype), _torch(w, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), _np32(want), rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("act", [None, "relu", "tanh", "silu", "square"])
def test_stripe_matmul_fused_epilogue(act):
    rng = np.random.RandomState(7)
    x, w, b = rng.randn(128, 256), rng.randn(256, 128), rng.randn(128)
    want = j_matmul_ref(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                        jnp.asarray(b, jnp.float32), act=act)
    got = matmul(_torch(x, "float32"), _torch(w, "float32"), _torch(b, "float32"), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-4)
    ref = matmul_ref(_torch(x, "float32"), _torch(w, "float32"), _torch(b, "float32"), act=act)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=1e-4)


def test_stripe_matmul_is_one_kernel_launch_compiled_for_h100():
    text = describe_kernel(256, 512, 384)
    assert "#grid" in text and "SMEM" in text
    call = build_matmul_kernel(256, 512, 384, "relu", True)
    plan = call.kernel.plan
    assert plan.out_ext == (384, 256) and plan.red_ext == (512,)
    assert plan.epi, "bias and activation are the fused epilogue"
