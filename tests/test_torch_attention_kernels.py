"""The port's attention and recurrence kernels (flash attention, chunked
GLA, mLSTM, SSD) against the JAX package's, on the CPU.

Each test makes its inputs with numpy from a seed and runs them through
the JAX function (its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and through the port, whose wrappers take
their plain PyTorch versions for CPU tensors; the tolerances are the
reference's own (flash 2e-5 in float32 and 5e-2 in bf16; GLA, mLSTM and
SSD 1e-4).  tests/test_torch_cuda.py and chip_smoke.py hold the CUDA
kernels against the same plain versions on the card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_attention_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.hwconfig import get_config as j_get_config  # noqa: E402
from repro.kernels.flash_attention import kernel as j_fa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.mlstm_chunk import kernel as j_gla  # noqa: E402
from repro.kernels.mlstm_chunk.ref import gla_ref as j_gla_ref  # noqa: E402
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref  # noqa: E402
from repro.kernels.ssd_chunk.kernel import ssd_chunk as j_ssd_chunk  # noqa: E402
from repro.kernels.ssd_chunk.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.nn.scan_ops import chunked_gla_jnp  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, choose_block_sizes, flash_attention  # noqa: E402
from repro_torch.kernels.mlstm_chunk import kernel as GLA  # noqa: E402
from repro_torch.kernels.mlstm_chunk import choose_chunk, chunked_gla, gla_ref, mlstm_chunk, mlstm_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_ref  # noqa: E402
from repro_torch.nn.scan_ops import chunked_gla_torch  # noqa: E402


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same array for both packages, in ``dtype``."""
    a = a.astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(rng, b, hq, hkv, sq, sk, d, dtype="float32"):
    q = _pair(rng.randn(b, hq, sq, d) * 0.5, dtype)
    k = _pair(rng.randn(b, hkv, sk, d) * 0.5, dtype)
    v = _pair(rng.randn(b, hkv, sk, d) * 0.5, dtype)
    return q, k, v


# --------------------------------------------------------- flash attention
@pytest.mark.parametrize("s,d,bq,bk", [(128, 64, 64, 64), (256, 64, 128, 64), (256, 128, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_shapes(s, d, bq, bk, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(s + d), 2, 4, 4, s, s, d)
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    before = FA.launches
    got = flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    assert FA.launches == before, "a CPU tensor never reaches the kernel"
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, s, d)
    _close(got, want, 2e-5)
    _close(attention_ref(tq, tk, tv, causal=causal), j_attention_ref(jq, jk, jv, causal=causal),
           2e-5)


def test_flash_attention_gqa():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(3), 2, 8, 2, 128, 128, 64)
    want = j_fa.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64), want, 2e-5)
    _close(attention_ref(tq, tk, tv, causal=True), want, 2e-5)


def test_flash_attention_bf16():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(4), 1, 2, 2, 128, 128, 64,
                                        "bfloat16")
    want = j_fa.flash_attention(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


@pytest.mark.parametrize("sq,sk,bq,bk", [(64, 256, 32, 64), (256, 64, 64, 32), (96, 192, 32, 64)])
def test_flash_attention_causal_top_left_when_sq_differs(sq, sk, bq, bk):
    """Causal with Sq != Sk: the mask is qpos >= kpos from 0 (top-left), and
    the kv loop stops at the block holding the tile's last query."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(sq + sk), 2, 4, 2, sq, sk, 32)
    want = j_fa.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk), want, 2e-5)


def test_flash_attention_default_blocks_and_scale():
    """No blocks given: both packages choose their own; the result is the
    same function (sm_scale 1/sqrt(D) by default, here also explicit)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(6), 1, 2, 1, 128, 128, 32)
    want = j_fa.flash_attention(jq, jk, jv, causal=True, sm_scale=0.3, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, sm_scale=0.3), want, 2e-5)
    want = j_fa.flash_attention(jq, jk, jv, causal=False, interpret=True)
    _close(flash_attention(tq, tk, tv, causal=False), want, 2e-5)


def test_flash_attention_refuses_what_the_reference_asserts():
    _, (_, tk), (_, tv) = _qkv(np.random.RandomState(7), 1, 2, 2, 64, 64, 16)
    tq = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention(tq, tk, tv, block_q=48, block_k=64)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 3, 64, 16), tk, tv, block_q=64, block_k=64)


@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 128), (2048, 2048, 128), (512, 2048, 128),
                                     (256, 256, 64), (128, 128, 64)])
def test_flash_block_search_under_tpu_v5e_is_the_reference(sq, sk, d):
    assert FA.search_params(get_config("tpu_v5e")) == {
        "cost": "roofline", "search": "pow2", "mem_cap_frac": 0.2, "count_untiled": True}
    assert FA.search_block_sizes(sq, sk, d, get_config("tpu_v5e")) == \
        j_fa.choose_block_sizes(sq, sk, d)


def test_flash_blocks_under_h100_fit_one_cta():
    hw = get_config("h100")
    smem = hw.mem("SMEM").size_bytes
    assert smem == 232_448
    assert FA.search_params(hw)["mem_cap_frac"] * hw.inner_mem().size_bytes == \
        pytest.approx(smem)
    # the reference's choice at this shape would hold a 4096-row tile
    assert j_fa.choose_block_sizes(4096, 4096, 128)[0] > FA.max_block_q(128)
    bq, bk = choose_block_sizes(4096, 4096, 128)
    assert 4096 % bq == 0 and 4096 % bk == 0
    assert bq <= FA.max_block_q(128) and FA.smem_bytes(bq, 128) <= smem
    assert bq >= 128 and bk >= 128  # as tests/test_kernels.py asks of the reference
    for sq, sk, d in ((2048, 2048, 128), (512, 2048, 128), (256, 256, 256)):
        bq, bk = choose_block_sizes(sq, sk, d)
        assert sq % bq == 0 and sk % bk == 0 and FA.smem_bytes(bq, d) <= smem


@pytest.mark.parametrize("block_q,d", [(128, 128), (64, 256), (8, 64), (100, 96)])
def test_flash_smem_and_rows(block_q, d):
    """The Python mirror of the kernel's geometry (the binding checks it
    against the compiled library on the card)."""
    r = FA.rows_per_warp(block_q)
    assert r & (r - 1) == 0 and FA.WARPS * r >= block_q
    assert FA.smem_bytes(block_q, d) <= 232_448
    assert block_q <= FA.max_block_q(d)


# ------------------------------------ flash attention on the tensor cores
def wgmma_emulation(q, k, v, causal, sm_scale=None):
    """The bf16 wgmma kernel's tile algorithm (csrc/flash_attention.cu) on
    the CPU: 128-row q tiles (two 64-row warpgroups; rows are
    independent), 64-key kv tiles up to the tile's last query under
    ``causal`` (keys past Sk zero and masked -inf, as the TMA box reads
    them), scores in float32 from the bf16 operands, the online softmax in
    log2 units, P rounded to bf16 for P V while l sums the float32 P, and
    one rounding of the output to bf16.  The package's plain version keeps
    the reference's float32 P; this emulation lives here, beside the
    tests that hold it."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    sl2 = torch.tensor((1.0 / d ** 0.5 if sm_scale is None else sm_scale)
                       * 1.4426950408889634, dtype=torch.float32)
    kf = torch.nn.functional.pad(k.float().repeat_interleave(hq // hkv, dim=1),
                                 (0, 0, 0, -sk % 64))
    vf = torch.nn.functional.pad(v.float().repeat_interleave(hq // hkv, dim=1),
                                 (0, 0, 0, -sk % 64))
    out = torch.zeros(b, hq, sq, d)
    for q0 in range(0, sq, 128):
        last = min(q0 + 128, sq) - 1
        kv_end = min(sk, last + 1) if causal else sk
        qt = q[:, :, q0:last + 1].float()
        qpos = torch.arange(q0, last + 1)[:, None]
        m = torch.full(qt.shape[:3], FA.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        o = torch.zeros(qt.shape)
        for k0 in range(0, kv_end, 64):
            kpos = torch.arange(k0, k0 + 64)[None, :]
            s = (qt @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * sl2
            s = torch.where(causal & (qpos < kpos), torch.full_like(s, FA.NEG_INF), s)
            s = torch.where(kpos >= sk, torch.full_like(s, -float("inf")), s)
            mx = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + 64]
            m = mx
        out[:, :, q0:last + 1] = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.bfloat16()


# the bf16 tolerance of the card's checks, over the largest output: the
# emulation rounds P to bf16 (each term of P V moves by at most 2**-8 of
# itself) and the output once (2**-8); the reference keeps P in float32
BF16_RTOL = 2e-2


def _close_bf16(got, want, q, k, v, causal):
    """Within BF16_RTOL of the largest output, and element by element
    within ``kernel.wgmma_bound``: one bf16 step of each output plus 2**-8
    of the attention of |v|, the most that rounding P to bf16 moves it."""
    g = got.float()
    w = want.float() if isinstance(want, torch.Tensor) else torch.as_tensor(
        np.asarray(want, np.float32))
    err = (g - w).abs()
    assert err.max().item() <= BF16_RTOL * (1 + w.abs().max().item()), err.max().item()
    excess = (err / FA.wgmma_bound(q, k, v, w, causal)).max().item()
    assert excess <= 1.0, excess
    return excess


# (B, Hq, Hkv, Sq, Sk, D, causal, block_q, block_k of the reference's call)
WGMMA_CASES = [
    (1, 4, 4, 256, 256, 128, True, 128, 128),
    (1, 4, 4, 256, 256, 128, False, 128, 64),
    (1, 8, 2, 128, 384, 64, True, 64, 128),    # Sq < Sk: top-left; GQA group 4
    (2, 4, 1, 192, 192, 64, True, 64, 64),     # S not a multiple of the 128-row tile
    (1, 2, 2, 320, 320, 64, False, 64, 64),    # 5 kv tiles, full
    (1, 4, 4, 448, 208, 128, True, 64, 16),    # Sq > Sk; Sk not a multiple of 64
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,bq,bk", WGMMA_CASES)
def test_wgmma_emulation_matches_the_pallas_kernel(b, hq, hkv, sq, sk, d, causal, bq, bk):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(sq + sk + d), b, hq, hkv, sq,
                                        sk, d, "bfloat16")
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                                interpret=True)
    got = wgmma_emulation(tq, tk, tv, causal)
    _close_bf16(got, want, tq, tk, tv, causal)
    # and the port's plain version (float32 P) on the same inputs
    _close_bf16(got, flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk),
                tq, tk, tv, causal)


def test_flash_path_rule():
    """The path depends on the type, the head dim and the alignment only:
    the tensor-core kernels run their own tiles whatever the blocks."""
    bf, f32 = torch.bfloat16, torch.float32
    assert FA.path_of(bf, 128) == "wgmma"
    assert FA.path_of(bf, 64) == "wgmma"
    assert FA.path_of(f32, 128) == "tf32x3"
    assert FA.path_of(f32, 64) == "tf32x3"
    assert FA.path_of(bf, 128, aligned=False) == "cuda_cores"
    assert FA.path_of(f32, 128, aligned=False) == "cuda_cores"
    assert FA.path_of(f32, 64, aligned=False) == "cuda_cores"
    for dtype, d in ((torch.float16, 64), (bf, 96), (bf, 32), (bf, 256), (f32, 96), (f32, 32),
                     (f32, 256), (f32, 16)):
        assert FA.path_of(dtype, d) == "cuda_cores", (dtype, d)


def test_wgmma_emulation_ignores_the_blocks():
    """The tile algorithm's result is the same whatever blocks the caller
    names, so explicit blocks such as 48 x 32 or 100 x 40 take the wgmma
    kernel too: against the Pallas kernel at those blocks it stays within
    the bound."""
    for sq, bq, bk in ((96, 48, 32), (200, 100, 40)):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(sq), 1, 2, 2, sq, sq, 64,
                                            "bfloat16")
        want = j_fa.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                                    interpret=True)
        _close_bf16(wgmma_emulation(tq, tk, tv, True), want, tq, tk, tv, True)


@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 128), (2048, 2048, 128), (512, 2048, 128),
                                     (4096, 4096, 64), (256, 256, 64), (64, 64, 64)])
def test_h100_blocks_take_wgmma_for_bf16(sq, sk, d):
    """Under h100 the autotiler's blocks for bf16 at head dim 64 and 128
    divide the sequence, and the call takes the wgmma kernel: llama3-8b's
    call needs no explicit blocks to reach the tensor cores."""
    bq, bk = choose_block_sizes(sq, sk, d)
    assert sq % bq == 0 and sk % bk == 0
    assert FA.path_of(torch.bfloat16, d) == "wgmma"


def test_flash_path_argument_on_cpu_tensors():
    (_, tq), (_, tk), (_, tv) = _qkv(np.random.RandomState(8), 1, 2, 2, 64, 64, 64, "bfloat16")
    before = (FA.launches, dict(FA.launches_by_path))
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64)
    assert torch.equal(flash_attention(tq, tk, tv, block_q=64, block_k=64, path="cuda_cores"),
                       got)
    assert (FA.launches, FA.launches_by_path) == before
    with pytest.raises(ValueError, match="path"):
        flash_attention(tq, tk, tv, path="wgmma")


# -------------------------------------------------------------- mlstm / GLA
def _gla_inputs(rng, B, H, S, Dk, Dv):
    q = _pair(rng.randn(B, H, S, Dk) * 0.5)
    k = _pair(rng.randn(B, H, S, Dk) * 0.5)
    v = _pair(rng.randn(B, H, S, Dv) * 0.5)
    return q, k, v


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (128, 128)])
def test_mlstm_chunk_matches_the_jax_kernel(s, chunk):
    rng = np.random.RandomState(s + chunk)
    B, H, Dk, Dv = 2, 2, 32, 32
    (jq, tq), (jk, tk), (jv, tv) = _gla_inputs(rng, B, H, s, Dk, Dv)
    ji, ti = _pair(rng.randn(B, H, s) * 0.5)
    jf, tf = _pair(rng.randn(B, H, s) * 0.5 + 2.0)
    want = j_gla.mlstm_chunk(jq, jk, jv, ji, jf, chunk=chunk, interpret=True)
    before = GLA.launches
    got = mlstm_chunk(tq, tk, tv, ti, tf, chunk=chunk)
    assert GLA.launches == before, "a CPU tensor never reaches the kernel"
    _close(got, want, 1e-4)
    _close(mlstm_ref(tq, tk, tv, ti, tf), j_mlstm_ref(jq, jk, jv, ji, jf), 1e-4)


@pytest.mark.parametrize("normalize", [True, False])
def test_gla_generic_matches_the_jax_kernel(normalize):
    rng = np.random.RandomState(11)
    B, H, S, Dk, Dv = 1, 2, 64, 16, 24
    (jq, tq), (jk, tk), (jv, tv) = _gla_inputs(rng, B, H, S, Dk, Dv)
    jld, tld = _pair(-np.abs(rng.randn(B, H, S)) * 0.2)
    jg, tg = _pair(np.abs(rng.randn(B, H, S)) * 0.5)
    want = j_gla.chunked_gla(jq, jk, jv, jld, jg, chunk=16, normalize=normalize, interpret=True)
    _close(chunked_gla(tq, tk, tv, tld, tg, chunk=16, normalize=normalize), want, 1e-4)
    _close(gla_ref(tq, tk, tv, tld, tg, normalize=normalize),
           j_gla_ref(jq, jk, jv, jld, jg, normalize=normalize), 1e-4)


@pytest.mark.parametrize("s,chunk,normalize", [(64, 16, True), (96, 64, False), (128, 256, True)])
def test_chunked_gla_torch_matches_chunked_gla_jnp(s, chunk, normalize):
    """The plain version against its JAX twin, including the chunk that is
    halved until it divides S (96 at 64 -> 32) and one larger than S."""
    rng = np.random.RandomState(s + chunk)
    B, H, Dk, Dv = 2, 3, 16, 8
    (jq, tq), (jk, tk), (jv, tv) = _gla_inputs(rng, B, H, s, Dk, Dv)
    jld, tld = _pair(-np.abs(rng.randn(B, H, s)) * 0.3)
    jg, tg = _pair(np.abs(rng.randn(B, H, s)) * 0.5)
    want = chunked_gla_jnp(jq, jk, jv, jld, jg, chunk=chunk, normalize=normalize, scale=0.7)
    got = chunked_gla_torch(tq, tk, tv, tld, tg, chunk=chunk, normalize=normalize, scale=0.7)
    _close(got, want, 1e-4)


def test_chunked_gla_refuses_a_chunk_that_does_not_divide():
    rng = np.random.RandomState(12)
    (_, tq), (_, tk), (_, tv) = _gla_inputs(rng, 1, 1, 96, 8, 8)
    ld, g = -torch.ones(1, 1, 96) * 0.1, torch.ones(1, 1, 96)
    with pytest.raises(ValueError, match="does not divide"):
        chunked_gla(tq, tk, tv, ld, g, chunk=64)


@pytest.mark.parametrize("seq,dk,dv", [(2048, 384, 384), (4096, 64, 64), (128, 32, 32),
                                       (96, 16, 24)])
def test_chunk_search_under_tpu_v5e_is_the_reference(seq, dk, dv):
    assert GLA.search_chunk(seq, dk, dv, get_config("tpu_v5e")) == \
        j_gla.choose_chunk(seq, dk, dv)


def test_chunk_under_h100_at_the_target_widths():
    """xlstm-125m (S 2048, Dk = Dv = 384) and zamba2-2.7b's Mamba2 layers
    (S 4096, N = P = 64): the search gives 512 and 1024 rows, the
    reference's clamp 256; the kernel's shared memory holds both."""
    for seq, dk, dv in ((2048, 384, 384), (4096, 64, 64)):
        c = choose_chunk(seq, dk, dv)
        assert c == 256 and seq % c == 0
        assert GLA.smem_bytes(dk, c) <= get_config("h100").mem("SMEM").size_bytes


# ------------------------------------------ chunked GLA on the tensor cores
def gla_wgmma_emulation(q, k, v, log_decay, gain, chunk, normalize=True, scale=1.0):
    """The bf16 wgmma path's two-pass decomposition (csrc/gla.cu) on the
    CPU, rounding to bf16 exactly where its kernels do.  The state pass
    walks the chunks: it records C_prev, the state before each chunk
    rounded to bf16, and n_prev in float32, then carries C in float32 as
    exp(total) C + (k w)^T v with k w rounded to bf16, and n as exp(total) n
    + sum_s k_s w_s from the unrounded products.  The output pass takes
    every chunk at once: scale exp(cum_t) q C_prev, the scores S = q k^T in
    float32, P = S scale exp(cum_t - cum_s) g_s with the mask inside the
    exp, O += bf16(P) V, the normalizer from the row sums of the float32 P
    and scale exp(cum_t) q . n_prev, and one rounding of the output."""
    b, h, s, dk = q.shape
    dv, nc = v.shape[-1], s // chunk
    qf = q.float().reshape(b * h, nc, chunk, dk)
    kf = k.float().reshape(b * h, nc, chunk, dk)
    vf = v.float().reshape(b * h, nc, chunk, dv)
    g = gain.float().reshape(b * h, nc, chunk)
    cum = torch.cumsum(log_decay.float().reshape(b * h, nc, chunk), dim=-1)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum) * g
    C, n = torch.zeros(b * h, dk, dv), torch.zeros(b * h, dk)
    c_prev, n_prev = [], []
    for c in range(nc):
        c_prev.append(C.bfloat16().float())
        n_prev.append(n)
        kw = kf[:, c] * w[:, c, :, None]
        et = torch.exp(total[:, c])
        C = et[:, None, None] * C + kw.bfloat16().float().transpose(1, 2) @ vf[:, c]
        n = et[:, None] * n + kw.sum(dim=1)
    c_prev, n_prev = torch.stack(c_prev, dim=1), torch.stack(n_prev, dim=1)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    dmat = torch.where(tril, cum[..., :, None] - cum[..., None, :], torch.tensor(-float("inf")))
    p = (qf @ kf.transpose(-1, -2)) * scale * torch.exp(dmat) * g[..., None, :]
    ecum = torch.exp(cum)
    o = scale * ecum[..., None] * (qf @ c_prev) + p.bfloat16().float() @ vf
    if normalize:
        norm = p.sum(dim=-1) + scale * ecum * (qf * n_prev[:, :, None, :]).sum(dim=-1)
        o = o / norm.abs().clamp(min=1.0)[..., None]
    return o.reshape(b, h, s, dv).bfloat16()


def _gla_gates(rng, kind, B, H, S):
    """(log_decay, gain) of an mLSTM (forget-gate bias 3, input gate
    clamped at 8), an SSD (dt > 0, A < 0), or a strong decay (log decay
    uniform down to -20, which the mask inside the exp has to hold)."""
    if kind == "mlstm":
        f = rng.randn(B, H, S) + 3.0
        i = rng.randn(B, H, S)
        return -np.logaddexp(0.0, -f), np.exp(np.minimum(i, 8.0))
    if kind == "ssd":
        dt = np.logaddexp(0.0, rng.randn(B, H, S))
        A = -np.linspace(1.0, 16.0, H)
        return dt * A[None, :, None], dt
    return -20.0 * rng.rand(B, H, S), 0.5 + rng.rand(B, H, S)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["mlstm", "ssd", "strong"])
def test_gla_wgmma_emulation_matches_the_pallas_kernel(kind, normalize, chunk):
    """The decomposition of the wgmma path against the JAX kernel in
    interpret mode (bf16 inputs, Dk 128 != Dv 64, S 256): within the bf16
    tolerance of the largest output, and element by element within
    ``kernel.gla_wgmma_bound`` (largest error over bound <= 1); and
    against the port's plain version the same way."""
    B, H, S, Dk, Dv = 1, 2, 256, 128, 64
    rng = np.random.RandomState(chunk + len(kind) + normalize)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.randn(B, H, S, d) * 0.5, "bfloat16")
                                    for d in (Dk, Dk, Dv))
    ld, g = _gla_gates(rng, kind, B, H, S)
    (jld, tld), (jg, tg) = _pair(ld), _pair(g)
    scale = Dk ** -0.5 if kind == "mlstm" else 1.0
    want = j_gla.chunked_gla(jq, jk, jv, jld, jg, chunk=chunk, normalize=normalize,
                             scale=scale, interpret=True)
    got = gla_wgmma_emulation(tq, tk, tv, tld, tg, chunk, normalize, scale)
    plain = chunked_gla(tq, tk, tv, tld, tg, chunk=chunk, normalize=normalize, scale=scale)
    for ref in (torch.as_tensor(np.asarray(want, np.float32)), plain.float()):
        err = (got.float() - ref).abs()
        assert err.max().item() <= BF16_RTOL * (1 + ref.abs().max().item()), err.max().item()
        bound = GLA.gla_wgmma_bound(tq, tk, tv, tld, tg, ref, chunk, normalize, scale)
        excess = (err / bound).max().item()
        print(f"{kind} normalize={normalize} chunk {chunk}: error / bound {excess:.3f}")
        assert excess <= 1.0, excess


def test_gla_path_rule():
    """bf16 with Dk and Dv multiples of 16, the chunk a multiple of 64 and
    aligned inputs takes wgmma; float32 with Dk and Dv multiples of 8 and
    the same chunk and alignment tf32x3; everything else the CUDA cores."""
    bf, f32 = torch.bfloat16, torch.float32
    for dk, dv, chunk in ((384, 384, 256), (64, 64, 256), (128, 64, 64), (16, 16, 64),
                          (48, 80, 128)):
        assert GLA.path_of(bf, dk, dv, chunk) == "wgmma", (dk, dv, chunk)
    for dk, dv, chunk in ((384, 384, 256), (64, 64, 256), (128, 64, 64), (16, 16, 64),
                          (40, 96, 128), (8, 8, 64), (48, 24, 192)):
        assert GLA.path_of(f32, dk, dv, chunk) == "tf32x3", (dk, dv, chunk)
    assert GLA.path_of(bf, 128, 64, 64, aligned=False) == "cuda_cores"
    assert GLA.path_of(f32, 128, 64, 64, aligned=False) == "cuda_cores"
    for dtype, dk, dv, chunk in ((bf, 40, 64, 64), (bf, 64, 24, 64), (bf, 64, 64, 32),
                                 (bf, 64, 64, 96), (torch.float16, 64, 64, 64),
                                 (f32, 64, 64, 16), (f32, 64, 64, 32), (f32, 4, 64, 64),
                                 (f32, 64, 12, 64), (f32, 64, 64, 96)):
        assert GLA.path_of(dtype, dk, dv, chunk) == "cuda_cores", (dtype, dk, dv, chunk)


def test_gla_target_widths_take_wgmma_in_bf16():
    """Phase 8's calls (xlstm-125m: S 2048, Dk = Dv = 384; zamba2-2.7b's
    SSD: S 4096, N = P = 64) at the chunk the autotiler picks take the
    wgmma path in bf16, and both of its kernels fit one CTA, two to an SM
    at xlstm-125m's width; in float32 they take tf32x3, whose state kernel
    fits two CTAs to an SM and whose output kernel one at xlstm-125m's
    width (its q tile alone is 96 KiB), three at the SSD's."""
    limit = get_config("h100").mem("SMEM").size_bytes
    for seq, dk, dv, outs in ((2048, 384, 384, 1), (4096, 64, 64, 3)):
        c = choose_chunk(seq, dk, dv)
        assert GLA.path_of(torch.bfloat16, dk, dv, c) == "wgmma"
        assert GLA.path_of(torch.float32, dk, dv, c) == "tf32x3"
        assert 2 * max(GLA.wgmma_smem_bytes(dk, dv, c)) <= limit
        state, out = GLA.tf32x3_smem_bytes(dk, dv, c)
        assert 2 * state <= limit
        assert outs * out <= limit < (outs + 1) * out


# --------------------------------------- chunked GLA in float32 on the tensor cores
def _tf32(x: torch.Tensor, rn: bool = False) -> torch.Tensor:
    """x as the tensor cores read it in tf32: its low 13 mantissa bits
    cleared, after rounding the rest to nearest (half away from zero) if
    ``rn``."""
    b = x.float().contiguous().view(torch.int32)
    if rn:
        b = b + 0x1000
    return (b & -8192).view(torch.float32)


def _mm_tf32(a, b, lo=True, rn=False):
    """a @ b as the tf32x3 path computes it, a_hi b_hi + a_hi b_lo + a_lo
    b_hi in float32 (hi cleared exactly, lo = x - hi read as tf32 by
    truncation, or by rounding if ``rn``); with ``lo`` False plain TF32,
    tf32(a) tf32(b)."""
    if not lo:
        return _tf32(a, rn) @ _tf32(b, rn)
    ah, bh = _tf32(a), _tf32(b)
    return ah @ bh + ah @ _tf32(b - bh, rn) + _tf32(a - ah, rn) @ bh


def gla_tf32x3_emulation(q, k, v, log_decay, gain, chunk, normalize=True, scale=1.0, lo=True,
                         rn=False):
    """The float32 tf32x3 path's two-pass decomposition (csrc/gla.cu) on
    the CPU, with its four products, (k w)^T v, q C_prev, q k^T and P V,
    each computed as :func:`_mm_tf32` does, bit by bit, and the decays'
    prefix sums in float64 as the kernels take them (differences to
    float32 before the exp; exp(cum_t) and exp(total) in float64).  The state pass
    records C_prev and n_prev before each chunk (float32; the kernel stores
    C_prev as hi + lo, exactly) and carries C as exp(total) C + (k w)^T v,
    n as exp(total) n + sum_s k_s w_s; the output pass takes every chunk at
    once: scale exp(cum_t) q C_prev, P = q k^T scale exp(cum_t - cum_s)
    g_s with the mask inside the exp, O += P V, the normalizer from the
    row sums of P and scale exp(cum_t) q . n_prev.  ``lo`` False drops the
    lo terms: plain TF32."""
    b, h, s, dk = q.shape
    dv, nc = v.shape[-1], s // chunk
    qf = q.float().reshape(b * h, nc, chunk, dk)
    kf = k.float().reshape(b * h, nc, chunk, dk)
    vf = v.float().reshape(b * h, nc, chunk, dv)
    g = gain.float().reshape(b * h, nc, chunk)
    cum = torch.cumsum(log_decay.float().reshape(b * h, nc, chunk).double(), dim=-1)
    total = cum[..., -1]
    w = torch.exp((total[..., None] - cum).float()) * g
    C, n = torch.zeros(b * h, dk, dv), torch.zeros(b * h, dk)
    c_prev, n_prev = [], []
    for c in range(nc):
        c_prev.append(C)
        n_prev.append(n)
        kw = kf[:, c] * w[:, c, :, None]
        et = torch.exp(total[:, c]).float()
        C = et[:, None, None] * C + _mm_tf32(kw.transpose(1, 2), vf[:, c], lo, rn)
        n = et[:, None] * n + kw.sum(dim=1)
    c_prev, n_prev = torch.stack(c_prev, dim=1), torch.stack(n_prev, dim=1)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    dmat = torch.where(tril, (cum[..., :, None] - cum[..., None, :]).float(),
                       torch.tensor(-float("inf")))
    p = _mm_tf32(qf, kf.transpose(-1, -2), lo, rn) * scale * torch.exp(dmat) * g[..., None, :]
    ecum = torch.exp(cum).float()
    o = scale * ecum[..., None] * _mm_tf32(qf, c_prev, lo, rn) + _mm_tf32(p, vf, lo, rn)
    if normalize:
        norm = p.sum(dim=-1) + scale * ecum * (qf * n_prev[:, :, None, :]).sum(dim=-1)
        o = o / norm.abs().clamp(min=1.0)[..., None]
    return o.reshape(b, h, s, dv)


def _gla_f32_case(kind, normalize, chunk, dk, dv, S=256):
    """Float32 q, k, v (B 1, H 2) and the gates of ``kind``, for both
    packages: (jax inputs, torch inputs)."""
    rng = np.random.RandomState(chunk + len(kind) + normalize + dk)
    pairs = [_pair(rng.randn(1, 2, S, d) * 0.5) for d in (dk, dk, dv)]
    pairs += [_pair(x) for x in _gla_gates(rng, kind, 1, 2, S)]
    return tuple(j for j, _ in pairs), tuple(t for _, t in pairs)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["mlstm", "ssd", "strong"])
def test_gla_tf32x3_emulation_matches_the_pallas_kernel(kind, normalize, chunk):
    """The decomposition of the tf32x3 path against the JAX kernel in
    interpret mode (float32 inputs, Dk 128 != Dv 64, S 256): within 1e-4
    of the largest output, and element by element within
    ``kernel.gla_tf32x3_bound`` (largest error over bound <= 1); and
    against the port's plain version the same way."""
    jins, tins = _gla_f32_case(kind, normalize, chunk, 128, 64)
    scale = 128 ** -0.5 if kind == "mlstm" else 1.0
    want = j_gla.chunked_gla(*jins, chunk=chunk, normalize=normalize, scale=scale,
                             interpret=True)
    got = gla_tf32x3_emulation(*tins, chunk, normalize, scale)
    plain = chunked_gla(*tins, chunk=chunk, normalize=normalize, scale=scale)
    for ref in (torch.as_tensor(np.asarray(want, np.float32)), plain):
        err = (got.double() - ref.double()).abs()
        assert err.max().item() <= 1e-4 * (1 + ref.abs().max().item()), err.max().item()
        bound = GLA.gla_tf32x3_bound(*tins, ref, chunk, normalize, scale)
        excess = (err / bound).max().item()
        print(f"{kind} normalize={normalize} chunk {chunk}: error / bound {excess:.3f}")
        assert excess <= 1.0, excess


@pytest.mark.parametrize("rn", [False, True])
@pytest.mark.parametrize("kind,normalize,chunk,dk,dv", [
    ("mlstm", True, 128, 384, 384),  # xlstm-125m's head width
    ("ssd", False, 64, 64, 64),      # the SSD's
    ("strong", True, 64, 128, 64),
])
def test_gla_tf32x3_bound_catches_plain_tf32(kind, normalize, chunk, dk, dv, rn):
    """Plain TF32 (the emulation with the lo terms dropped, the operands
    truncated or rounded to nearest) exceeds ``kernel.gla_tf32x3_bound``
    against the plain version, where 3xTF32 on the same inputs stays
    within it: the bound has teeth at K = 384 too."""
    _, tins = _gla_f32_case(kind, normalize, chunk, dk, dv)
    scale = dk ** -0.5 if kind == "mlstm" else 1.0
    plain = chunked_gla(*tins, chunk=chunk, normalize=normalize, scale=scale)
    bound = GLA.gla_tf32x3_bound(*tins, plain, chunk, normalize, scale)
    excess = {}
    for lo in (True, False):
        got = gla_tf32x3_emulation(*tins, chunk, normalize, scale, lo=lo, rn=rn)
        excess[lo] = ((got.double() - plain.double()).abs() / bound).max().item()
    print(f"{kind} Dk {dk}: error / bound, 3xTF32 {excess[True]:.3f}, TF32 {excess[False]:.1f}")
    assert excess[True] <= 1.0 < excess[False], excess


def test_gla_path_argument_on_cpu_tensors():
    rng = np.random.RandomState(9)
    (_, tq), (_, tk), (_, tv) = _gla_inputs(rng, 1, 2, 128, 64, 64)
    tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    ld, g = -torch.rand(1, 2, 128), torch.rand(1, 2, 128)
    before = (GLA.launches, dict(GLA.launches_by_path))
    got = chunked_gla(tq, tk, tv, ld, g, chunk=64)
    assert torch.equal(chunked_gla(tq, tk, tv, ld, g, chunk=64, path="cuda_cores"), got)
    assert (GLA.launches, GLA.launches_by_path) == before
    with pytest.raises(ValueError, match="path"):
        chunked_gla(tq, tk, tv, ld, g, chunk=64, path="wgmma")


# ----------------------------- flash attention in float32 on the tensor cores
def flash_tf32x3_emulation(q, k, v, causal, sm_scale=None, lo=True, rn=False):
    """The float32 tf32x3 kernel's tile algorithm (csrc/flash_attention.cu)
    on the CPU: 32-key kv tiles (keys past Sk zero and masked -inf, as the
    TMA box and the zero-padded v^T read them) up to the last query under
    ``causal``, S = Q K^T and O += P V each as :func:`_mm_tf32` computes
    it, scores in log2 units, the causal mask -1e30, the online softmax
    with l summing the float32 P.  Every q row at once: a tile past a
    row's diagonal adds exactly 0 (its probabilities are 0 and the running
    max does not move), so where a CTA's kv loop ends does not change a
    row.  ``lo`` False drops the lo terms: plain TF32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    sl2 = torch.tensor((1.0 / d ** 0.5 if sm_scale is None else sm_scale)
                       * 1.4426950408889634, dtype=torch.float32)
    kf, vf = (torch.nn.functional.pad(t.float().repeat_interleave(hq // hkv, dim=1),
                                      (0, 0, 0, -sk % 32)) for t in (k, v))
    qf = q.float()
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq), FA.NEG_INF)
    l = torch.zeros(b, hq, sq)
    o = torch.zeros(b, hq, sq, d)
    for k0 in range(0, min(sk, sq) if causal else sk, 32):
        kpos = torch.arange(k0, k0 + 32)[None, :]
        s = _mm_tf32(qf, kf[:, :, k0:k0 + 32].transpose(-1, -2), lo, rn) * sl2
        s = torch.where(causal & (qpos < kpos), torch.full_like(s, FA.NEG_INF), s)
        s = torch.where(kpos >= sk, torch.full_like(s, -float("inf")), s)
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _mm_tf32(p, vf[:, :, k0:k0 + 32], lo, rn)
        m = mx
    return o / torch.where(l == 0, torch.ones_like(l), l)[..., None]


def _tf32x3_excess(got, want, q, k, v, causal):
    """Within 1e-4 of the largest output, and the largest error over
    ``kernel.flash_tf32x3_bound`` (returned)."""
    w = want.double() if isinstance(want, torch.Tensor) else torch.as_tensor(
        np.asarray(want, np.float64))
    err = (got.double() - w).abs()
    assert err.max().item() <= 1e-4 * (1 + w.abs().max().item()), err.max().item()
    return (err / FA.flash_tf32x3_bound(q, k, v, w, causal)).max().item()


# (B, Hq, Hkv, Sq, Sk, D, causal, block_q, block_k of the reference's call)
TF32X3_CASES = [
    (1, 4, 4, 256, 256, 128, True, 128, 128),
    (1, 4, 4, 256, 256, 128, False, 128, 64),
    (1, 8, 2, 128, 384, 64, True, 64, 128),    # Sq < Sk: top-left; GQA group 4
    (2, 4, 1, 192, 192, 64, True, 64, 64),     # S not a multiple of the 128-row tile
    (1, 4, 2, 96, 204, 128, False, 32, 68),    # Sk not a multiple of 8 nor of the 32-key tile
    (1, 4, 4, 160, 100, 64, True, 32, 20),     # Sq > Sk; Sk not a multiple of 8
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,bq,bk", TF32X3_CASES)
def test_flash_tf32x3_emulation_matches_the_pallas_kernel(b, hq, hkv, sq, sk, d, causal, bq,
                                                          bk):
    """The tf32x3 tile algorithm against the JAX kernel in interpret mode
    (float32): within 1e-4 of the largest output and element by element
    within ``kernel.flash_tf32x3_bound``; and against the port's plain
    version the same way."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.RandomState(sq + sk + d + 1), b, hq, hkv, sq,
                                        sk, d)
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                                interpret=True)
    got = flash_tf32x3_emulation(tq, tk, tv, causal)
    plain = flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    for ref in (want, plain):
        excess = _tf32x3_excess(got, ref, tq, tk, tv, causal)
        print(f"Sq {sq} Sk {sk} D {d} causal={causal}: error / bound {excess:.3f}")
        assert excess <= 1.0, excess


@pytest.mark.parametrize("rn", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_bound_catches_plain_tf32(causal, rn):
    """Plain TF32 (the emulation with the lo terms dropped, the operands
    truncated or rounded to nearest) exceeds ``kernel.flash_tf32x3_bound``
    against the plain version at llama3-8b's head dim 128 and GQA group 4,
    where 3xTF32 on the same inputs stays within it."""
    rng = np.random.RandomState(11 + causal)
    tq, tk, tv = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  for shape in ((1, 8, 256, 128), (1, 2, 256, 128), (1, 2, 256, 128)))
    plain = flash_attention(tq, tk, tv, causal=causal, block_q=128, block_k=128)
    bound = FA.flash_tf32x3_bound(tq, tk, tv, plain, causal)
    excess = {}
    for lo in (True, False):
        got = flash_tf32x3_emulation(tq, tk, tv, causal, lo=lo, rn=rn)
        excess[lo] = ((got.double() - plain.double()).abs() / bound).max().item()
    print(f"causal={causal} rn={rn}: error / bound, 3xTF32 {excess[True]:.3f}, "
          f"TF32 {excess[False]:.1f}")
    assert excess[True] <= 1.0 < excess[False], excess


@pytest.mark.parametrize("d", [64, 128])
def test_flash_tf32x3_smem_fits_one_cta(d):
    """The tf32x3 kernel's shared memory (the binding checks the Python
    mirror against the compiled library on the card) fits one H100 block:
    the Q tile and at least two 32-key stages."""
    limit = get_config("h100").mem("SMEM").size_bytes
    assert FA.tf32x3_stages(d) >= 2
    assert FA.tf32x3_smem_bytes(d) <= limit


# --------------------------------------------------------------- ssd_chunk
@pytest.mark.parametrize("s,p,n", [(64, 16, 8), (128, 32, 16)])
def test_ssd_chunk_matches_the_jax_kernel(s, p, n):
    rng = np.random.RandomState(s)
    B, H = 2, 2
    jx, tx = _pair(rng.randn(B, H, s, p) * 0.5)
    jdt, tdt = _pair(np.abs(rng.randn(B, H, s)) * 0.3)
    jA, tA = _pair(-np.abs(rng.randn(H)))
    jB, tB = _pair(rng.randn(B, H, s, n) * 0.5)
    jC, tC = _pair(rng.randn(B, H, s, n) * 0.5)
    jD, tD = _pair(rng.randn(H))
    want = j_ssd_chunk(jx, jdt, jA, jB, jC, jD, chunk=32, interpret=True)
    _close(ssd_chunk(tx, tdt, tA, tB, tC, tD, chunk=32), want, 1e-4)
    _close(ssd_ref(tx, tdt, tA, tB, tC, tD), j_ssd_ref(jx, jdt, jA, jB, jC, jD), 1e-4)


def test_ssd_no_skip_connection():
    rng = np.random.RandomState(13)
    B, H, S, P, N = 1, 2, 64, 16, 8
    jx, tx = _pair(rng.randn(B, H, S, P) * 0.5)
    jdt, tdt = _pair(np.abs(rng.randn(B, H, S)) * 0.3)
    jA, tA = _pair(-np.abs(rng.randn(H)))
    jB, tB = _pair(rng.randn(B, H, S, N) * 0.5)
    jC, tC = _pair(rng.randn(B, H, S, N) * 0.5)
    want = j_ssd_chunk(jx, jdt, jA, jB, jC, None, chunk=16, interpret=True)
    _close(ssd_chunk(tx, tdt, tA, tB, tC, None, chunk=16), want, 1e-4)


# ----------------------------------------------------------------- facade
def test_params_from_jax_defaults_to_the_card():
    tree = {"w": np.ones((2, 3), np.float32), "blk": {"b": np.zeros(3, np.float32)}}
    if torch.cuda.is_available():
        assert api.params_from_jax(tree)["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            api.params_from_jax(tree)
    got = api.params_from_jax(tree, "cpu")
    assert got["blk"]["b"].device.type == "cpu" and got["w"].shape == (2, 3)


def test_api_exports_the_reference_kernel_names():
    import repro.api as j_api

    for name in ("choose_block_sizes", "matmul", "matmul_ref"):
        assert name in api.__all__ and name in j_api.__all__
    assert api.choose_block_sizes is choose_block_sizes
    x, w = torch.randn(64, 32), torch.randn(32, 16)
    torch.testing.assert_close(api.matmul(x, w), api.matmul_ref(x, w), rtol=1e-4, atol=1e-4)


def test_hardware_configs_agree_on_the_search_inputs():
    """The port's tpu_v5e is the reference's, so the two searches above
    price the same machine."""
    assert get_config("tpu_v5e").fingerprint() == j_get_config("tpu_v5e").fingerprint()
