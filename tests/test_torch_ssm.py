"""The port's recurrent layers and cross-attention against the JAX
package's, on the CPU.

The same numpy inputs (drawn from a seed) and the same weights (the JAX
package's initializers, carried over with ``params_from_jax``) go through
the reference function and its port, in float32:

* ``nn.scan_ops.gla_decode_step`` with ``normalize`` true and false: the
  output and the new (C, n) within 1e-5 of the largest;
* ``nn.ssm.mamba2_apply`` and ``nn.xlstm.mlstm_block_apply`` in their
  three modes (no state; prefill with a state; one-token decode from a
  state), ``nn.xlstm.slstm_block_apply`` with and without a state: the
  output and every leaf of the new state within 1e-4 of the largest;
* ``nn.attention.attention(memory=)``, with and without a mask;
* S = 100, where the chunk of 256 is not a power of two that divides S
  (``chunked_gla`` runs one chunk of 100, or halves 64 to 4), for the
  chunked GLA itself and a Mamba2 prefill.

The port's blocks write a state passed in (donated); the tests hold what
they return.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.nn import attention as j_attn  # noqa: E402
from repro.nn import scan_ops as j_scan  # noqa: E402
from repro.nn import ssm as j_ssm  # noqa: E402
from repro.nn import xlstm as j_xlstm  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.nn import attention as t_attn  # noqa: E402
from repro_torch.nn import scan_ops as t_scan  # noqa: E402
from repro_torch.nn import ssm as t_ssm  # noqa: E402
from repro_torch.nn import xlstm as t_xlstm  # noqa: E402


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _assert_close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(scale, 1.0), f"{what}: max error {err:.3e} (scale {scale:.3e})"


def _cfgs(name):
    return j_configs.get(name).scaled(), api.configs.get(name).scaled()


def _pair(a):
    """A numpy array as (jax array, torch tensor)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _params(j_init, cfg):
    jp = j_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    return jp, api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _random_state(j_init_state, r, scale=0.5, **kw):
    """A nonzero state of the reference's shapes: (jax dict, torch dict)."""
    shapes = jax.tree.map(lambda a: a.shape, j_init_state(**kw))
    pairs = {k: _pair(r.randn(*s) * scale + (1.0 if k == "n" else 0.0))
             for k, s in shapes.items()}
    return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}


def _assert_state(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        _assert_close(got[k], want[k], 1e-4, f"{what} state {k}")


# -------------------------------------------------------------- scan_ops
@pytest.mark.parametrize("normalize", [True, False])
def test_gla_decode_step_matches_reference(normalize):
    r = np.random.RandomState(0)
    b, h, dk, dv = 2, 3, 8, 5
    q, k = _pair(r.randn(b, h, dk)), _pair(r.randn(b, h, dk))
    v = _pair(r.randn(b, h, dv))
    ld, g = _pair(-np.abs(r.randn(b, h))), _pair(np.abs(r.randn(b, h)))
    C, n = _pair(r.randn(b, h, dk, dv)), _pair(r.randn(b, h, dk))
    jo, (jC, jn) = j_scan.gla_decode_step(q[0], k[0], v[0], ld[0], g[0], (C[0], n[0]),
                                          normalize=normalize, scale=0.5)
    to, (tC, tn) = t_scan.gla_decode_step(q[1], k[1], v[1], ld[1], g[1], (C[1], n[1]),
                                          normalize=normalize, scale=0.5)
    for got, want, what in ((to, jo, "out"), (tC, jC, "C"), (tn, jn, "n")):
        assert got.dtype == torch.float32
        _assert_close(got, want, 1e-5, what)


@pytest.mark.parametrize("chunk", [256, 64])
def test_chunked_gla_at_a_length_of_100_matches_reference(chunk):
    """S = 100: a chunk of 256 becomes one chunk of 100; 64 halves to 4."""
    r = np.random.RandomState(1)
    b, h, s, dk, dv = 1, 2, 100, 8, 8
    q, k, v = (_pair(r.randn(b, h, s, d) * 0.5) for d in (dk, dk, dv))
    ld, g = _pair(-np.abs(r.randn(b, h, s)) * 0.1), _pair(np.abs(r.randn(b, h, s)))
    for normalize in (True, False):
        want = j_scan.chunked_gla_jnp(q[0], k[0], v[0], ld[0], g[0], chunk=chunk,
                                      normalize=normalize)
        got = t_scan.chunked_gla_torch(q[1], k[1], v[1], ld[1], g[1], chunk=chunk,
                                       normalize=normalize)
        _assert_close(got, want, 1e-4, f"chunk {chunk} normalize {normalize}")


# ----------------------------------------------------------------- mamba2
MODES = ["train", "prefill", "decode"]


def _mode_inputs(mode, j_init_state, r, d, s=12, **kw):
    x = _pair(r.randn(2, 1 if mode == "decode" else s, d))
    if mode == "train":
        return x, (None, None)
    if mode == "prefill":
        st = j_init_state(**kw)
        return x, (st, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in st.items()})
    return x, _random_state(j_init_state, r, **kw)


@pytest.mark.parametrize("mode,s", [(m, 12) for m in MODES] + [("train", 100), ("prefill", 100)])
def test_mamba2_apply_matches_reference(mode, s):
    jcfg, tcfg = _cfgs("zamba2-2.7b")
    jp, tp = _params(j_ssm.mamba2_init, jcfg)
    r = np.random.RandomState(2)
    x, (jst, tst) = _mode_inputs(
        mode, lambda **kw: j_ssm.mamba2_init_state(jcfg, 2, jnp.float32), r, jcfg.d_model, s)
    jo, jnew = j_ssm.mamba2_apply(jp, x[0], jcfg, state=jst)
    to, tnew = t_ssm.mamba2_apply(tp, x[1], tcfg, state=tst)
    _assert_close(to, jo, 1e-4, f"mamba2 {mode} out")
    if mode == "train":
        assert tnew is None and jnew is None
    else:
        _assert_state(tnew, jnew, f"mamba2 {mode}")


@pytest.mark.parametrize("mode", MODES)
def test_mlstm_block_apply_matches_reference(mode):
    jcfg, tcfg = _cfgs("xlstm-125m")
    jp, tp = _params(j_xlstm.mlstm_block_init, jcfg)
    r = np.random.RandomState(3)
    x, (jst, tst) = _mode_inputs(
        mode, lambda **kw: j_xlstm.mlstm_init_state(jcfg, 2, jnp.float32), r, jcfg.d_model)
    jo, jnew = j_xlstm.mlstm_block_apply(jp, x[0], jcfg, state=jst)
    to, tnew = t_xlstm.mlstm_block_apply(tp, x[1], tcfg, state=tst)
    _assert_close(to, jo, 1e-4, f"mlstm {mode} out")
    if mode == "train":
        assert tnew is None and jnew is None
    else:
        _assert_state(tnew, jnew, f"mlstm {mode}")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_apply_matches_reference(with_state):
    jcfg, tcfg = _cfgs("xlstm-125m")
    jp, tp = _params(j_xlstm.slstm_block_init, jcfg)
    r = np.random.RandomState(4)
    x = _pair(r.randn(2, 9, jcfg.d_model))
    jst, tst = (_random_state(lambda **kw: j_xlstm.slstm_init_state(jcfg, 2), r)
                if with_state else (None, None))
    jo, jnew = j_xlstm.slstm_block_apply(jp, x[0], jcfg, state=jst)
    to, tnew = t_xlstm.slstm_block_apply(tp, x[1], tcfg, state=tst)
    _assert_close(to, jo, 1e-4, "slstm out")
    if with_state:
        _assert_state(tnew, jnew, "slstm")
    else:
        assert tnew is None and jnew is None


def test_a_state_passed_in_is_written_in_place():
    """The blocks donate their state: the buffers passed in hold the new
    state and are the ones returned (no copy of the whole state a call)."""
    _jcfg, cfg = _cfgs("zamba2-2.7b")
    gen = torch.Generator().manual_seed(0)
    p = t_ssm.mamba2_init(gen, cfg, torch.float32, "cpu")
    st = t_ssm.mamba2_init_state(cfg, 2, torch.float32, "cpu")
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    _out, new = t_ssm.mamba2_apply(p, x, cfg, state=st)
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    assert all(v.abs().sum() > 0 for v in st.values())
    xcfg = _cfgs("xlstm-125m")[1]
    sp = t_xlstm.slstm_block_init(gen, xcfg, torch.float32, "cpu")
    sst = t_xlstm.slstm_init_state(xcfg, 2, "cpu")
    ptrs = {k: v.data_ptr() for k, v in sst.items()}
    _out, new = t_xlstm.slstm_block_apply(sp, torch.randn(2, 3, xcfg.d_model, generator=gen),
                                          xcfg, state=sst)
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    assert sst["h"].abs().sum() > 0


# -------------------------------------------------------- cross-attention
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["seamless-m4t-large-v2", "qwen3-4b"])
def test_cross_attention_matches_reference(name, masked):
    """``attention(memory=)``: k and v from the memory, no RoPE, no cache,
    the mask passed to ``mha`` as given (qwen3-4b: GQA and qk-norm)."""
    jcfg, tcfg = _cfgs(name)
    jp = j_attn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32, cross=True)
    tp = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    r = np.random.RandomState(5)
    x, mem = _pair(r.randn(2, 7, jcfg.d_model)), _pair(r.randn(2, 11, jcfg.d_model))
    jm = tm = None
    if masked:
        m = r.rand(2, 1, 7, 11) > 0.3
        m[..., 0] = True
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    jo, jc = j_attn.attention(jp, x[0], jcfg, memory=mem[0], mask=jm, causal=False)
    to, tc = t_attn.attention(tp, x[1], tcfg, memory=mem[1], mask=tm, causal=False)
    assert tc is None and jc is None
    _assert_close(to, jo, 1e-4, f"{name} cross-attention")
    # the memory's k and v, not x's: another memory gives another output
    other, _ = t_attn.attention(tp, x[1], tcfg, memory=mem[1].flip(1), mask=tm, causal=False)
    assert not torch.allclose(other, to)
