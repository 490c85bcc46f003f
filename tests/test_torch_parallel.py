"""The port's SPMD runner (``parallel/spmd.py``) and the collective
algorithms built on it against the JAX package's, run in ``shard_map`` on
the same numpy inputs: both ring matmuls and their baseline, sequence-
parallel decode attention, the GPipe pipeline, ZeRO-1 (also against
AdamW) and the error-feedback ``compressed_psum``; ``compat.axis_size``
and the mesh builders of ``launch/mesh.py``.

The ``distributed``-marked tests run the reference on the 8 emulated host
devices conftest forces before jax initializes; the port runs the same
8 ranks as threads on ``Mesh(["cpu"] * 8, ...)``.  Tolerances are float32
ones, relative to the largest reference value: ``1e-5`` where both sides
sum the same terms in the same order, ``1e-4`` where a product's K is
summed in another order (the reference's tests' own tolerance).
"""
import threading
import time
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import compress as j_compress  # noqa: E402
from repro.optim import zero1 as j_zero1  # noqa: E402
from repro.parallel import collective_matmul as j_cm  # noqa: E402
from repro.parallel import pipeline as j_pipe  # noqa: E402
from repro.parallel import sp_attention as j_sp  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.launch import mesh as t_launch  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compress as t_compress  # noqa: E402
from repro_torch.optim import zero1 as t_zero1  # noqa: E402
from repro_torch.parallel import collective_matmul as t_cm  # noqa: E402
from repro_torch.parallel import compat as t_compat  # noqa: E402
from repro_torch.parallel import pipeline as t_pipe  # noqa: E402
from repro_torch.parallel import sp_attention as t_sp  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.spmd import Mesh, P  # noqa: E402

distributed = pytest.mark.distributed


def _j_shard_map(fn, axis, in_specs, out_specs, n=8):
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    mesh = jax.make_mesh((n,), (axis,))
    try:
        sm = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    except TypeError:
        sm = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_rep=False)
    return jax.jit(sm)


def _mesh(axis, n=8):
    return Mesh(["cpu"] * n, (axis,))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    bound = rtol * (1.0 + float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max|port - ref| {err:.3e} > {bound:.3e}"


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------
def test_psum_is_taken_in_rank_order():
    """Every rank gets the same sum, bit for bit, and it is the left fold in
    rank order whatever the threads' timing."""
    vals = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0, -3.0, 0.5, 0.25], dtype=torch.float32)

    def body(x):
        time.sleep(0.01 * (7 - spmd.axis_index("x")))   # arrive in reverse order
        return spmd.psum(x, "x"), spmd.all_gather(spmd.psum(x, "x"), "x", tiled=True)

    total, every = spmd.shard_map(body, _mesh("x"), in_specs=(P("x"),),
                                  out_specs=(P(), P()))(vals)
    want = vals[0].clone()
    for v in vals[1:]:
        want = want + v
    assert torch.equal(total, want.reshape(1))
    assert torch.equal(every, want.reshape(1).repeat(8))


def test_ppermute_zero_fills_and_axis_index_and_size():
    def body(x):
        shifted = spmd.ppermute(x, "x", [(i, i + 1) for i in range(3)])
        idx = torch.tensor([spmd.axis_index("x"), spmd.axis_size("x"),
                            t_compat.axis_size("x")], dtype=torch.float32)
        return shifted, idx

    x = torch.arange(1, 5, dtype=torch.float32)
    got, idx = spmd.shard_map(body, _mesh("x", 4), in_specs=(P("x"),),
                              out_specs=(P("x"), P("x")))(x)
    assert torch.equal(got, torch.tensor([0.0, 1.0, 2.0, 3.0]))
    assert idx.reshape(4, 3).tolist() == [[r, 4, 4] for r in range(4)]


def test_collectives_group_along_one_axis_of_a_2d_mesh():
    devs = np.empty(8, dtype=object)
    devs[:] = ["cpu"] * 8
    mesh = Mesh(devs.reshape(2, 4), ("data", "model"))

    def body(x):
        return (spmd.psum(x, "model"), spmd.psum(x, "data"), spmd.pmax(x, ("data", "model")),
                spmd.psum_scatter(x.reshape(1).repeat(4), "model", scatter_dimension=0,
                                  tiled=True))

    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    by_model, by_data, top, scat = spmd.shard_map(
        body, mesh, in_specs=(P("data", "model"),),
        out_specs=(P("data", None), P(None, "model"), P(), P(("data", "model"))))(x)
    assert by_model.flatten().tolist() == [6.0, 22.0]
    assert by_data.flatten().tolist() == [4.0, 6.0, 8.0, 10.0]
    assert top.item() == 7.0
    assert scat.flatten().tolist() == [6.0] * 4 + [22.0] * 4


def test_psum_scatter_and_all_gather_untiled():
    def body(x):
        s = spmd.psum_scatter(x.reshape(4, -1), "x", scatter_dimension=0, tiled=False)
        return spmd.all_gather(s, "x", axis=0, tiled=False)

    x = torch.arange(32, dtype=torch.float32)
    got = spmd.shard_map(body, _mesh("x", 4), in_specs=(P(),), out_specs=P())(x)
    assert torch.equal(got, 4 * x.reshape(4, 8))


def test_a_rank_that_raises_fails_every_rank_within_the_time_limit():
    """A rank that raises aborts the others waiting in a collective: the call
    re-raises that rank's own exception at once, far inside the limit."""
    def body(x):
        if spmd.axis_index("x") == 2:
            raise KeyError("rank 2 failed")
        return spmd.psum(x, "x")

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 2 failed"):
        spmd.shard_map(body, _mesh("x", 4), in_specs=(P("x"),), out_specs=P(),
                       timeout=30.0)(torch.ones(4))
    assert time.perf_counter() - t0 < 10.0
    assert not [t for t in threading.enumerate() if t.name.startswith("spmd-rank")]


def test_a_rank_that_never_arrives_times_out_instead_of_hanging():
    def body(x):
        if spmd.axis_index("x") == 0:
            return x            # skips the collective the others wait in
        return spmd.psum(x, "x")

    t0 = time.perf_counter()
    with pytest.raises(spmd.CollectiveTimeout, match="within 0.5 s"):
        spmd.shard_map(body, _mesh("x", 4), in_specs=(P("x"),), out_specs=P(),
                       timeout=0.5)(torch.ones(4))
    assert time.perf_counter() - t0 < 10.0


def test_collectives_outside_shard_map_raise():
    with pytest.raises(NameError, match="not inside shard_map"):
        spmd.psum(torch.ones(2), "x")
    with pytest.raises(NameError):
        t_compress.compressed_psum(torch.ones(4), "data")


def test_shard_map_keeps_the_callers_grad_mode():
    def body(x):
        return torch.tensor([float(torch.is_grad_enabled())])

    fn = spmd.shard_map(body, _mesh("x", 2), in_specs=(P(),), out_specs=P("x"))
    with torch.no_grad():
        assert fn(torch.ones(1)).tolist() == [0.0, 0.0]
    assert fn(torch.ones(1)).tolist() == [1.0, 1.0]


def test_axis_size_inside_and_outside_shard_map():
    """``compat.axis_size`` resolves inside a rank, under an ambient
    ``with mesh:`` and from an explicit mesh, as the reference's."""
    mesh = _mesh("data")
    got = spmd.shard_map(lambda x: x * t_compat.axis_size("data"), mesh,
                         in_specs=(P(),), out_specs=P())(torch.ones(4))
    assert torch.equal(got, torch.full((4,), 8.0))
    with mesh:
        assert t_compat.axis_size("data") == 8
    assert t_compat.axis_size("data", mesh=mesh) == 8
    with pytest.raises(NameError):
        t_compat.axis_size("nonexistent_axis")


def test_mesh_builders_need_devices_or_take_explicit_ones():
    """A builder short of cards raises, as ``jax.make_mesh`` does;
    ``devices=`` emulates them.  The axis helpers answer as the
    reference's on the same shapes."""
    with pytest.raises(ValueError, match="devices="):
        t_launch.make_test_mesh(torch.cuda.device_count() + 2)
    m = t_launch.make_test_mesh(8, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert (t_launch.dp_axes(m), t_launch.tp_size(m), t_launch.dp_size(m)) == (("data",), 4, 2)
    p = t_launch.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert p.shape == {"pod": 2, "data": 16, "model": 16}
    assert (t_launch.dp_axes(p), t_launch.tp_size(p), t_launch.dp_size(p)) == (
        ("pod", "data"), 16, 32)
    assert api.Mesh is Mesh


@distributed
def test_mesh_axis_helpers_equal_reference():
    from repro.launch import mesh as j_launch

    jm = j_launch.make_test_mesh(8)
    tm = t_launch.make_test_mesh(8, devices=["cpu"] * 8)
    assert dict(tm.shape) == dict(jm.shape)
    assert t_launch.dp_axes(tm) == j_launch.dp_axes(jm)
    assert t_launch.tp_size(tm) == j_launch.tp_size(jm)
    assert t_launch.dp_size(tm) == j_launch.dp_size(jm)


# --------------------------------------------------------------------------
# the collective algorithms against the reference's, in shard_map
# --------------------------------------------------------------------------
@distributed
def test_ring_matmuls_match_reference_and_baseline():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    w = rng.randn(32, 48).astype(np.float32)
    cases = (
        ("ring_allgather_matmul", (JP("model", None), JP(None, "model")),
         (P("model", None), P(None, "model"))),
        ("ring_matmul_reduce_scatter", (JP(None, "model"), JP("model", None)),
         (P(None, "model"), P("model", None))),
        ("allgather_matmul_baseline", (JP("model", None), JP(None, "model")),
         (P("model", None), P(None, "model"))),
    )
    for name, jspec, tspec in cases:
        want = _j_shard_map(partial(getattr(j_cm, name), axis="model"), "model",
                            jspec, JP(None, "model"))(jnp.asarray(x), jnp.asarray(w))
        got = spmd.shard_map(partial(getattr(t_cm, name), axis="model"), _mesh("model"),
                             in_specs=tspec, out_specs=P(None, "model"))(_t(x), _t(w))
        _close(got, want, 1e-5, name)
        _close(got, x @ w, 1e-4, f"{name} against x @ w")


@distributed
def test_ring_matmuls_count_one_ppermute_site_and_their_trips():
    """A ring's loop is one collective call site (the reference's static
    count), its dynamic trips n (all-gather ring) and n - 1 (reduce-scatter
    ring)."""
    from repro_torch.core import mesh_lower as t_ml

    x, w = torch.randn(64, 32), torch.randn(32, 48)
    ag = spmd.shard_map(partial(t_cm.ring_allgather_matmul, axis="m"), _mesh("m"),
                        in_specs=(P("m", None), P(None, "m")), out_specs=P(None, "m"))
    rs = spmd.shard_map(partial(t_cm.ring_matmul_reduce_scatter, axis="m"), _mesh("m"),
                        in_specs=(P(None, "m"), P("m", None)), out_specs=P(None, "m"))
    for fn, trips in ((ag, 8), (rs, 7)):
        counts = t_ml.count_collectives(fn, {"x": x, "w": w})
        assert counts == {"ppermute": 1} and counts.trips == {"ppermute": trips}


@distributed
@pytest.mark.parametrize("valid", [(64, 32), (64, 64), (5, 0)])
def test_sp_decode_attention_matches_reference(valid):
    rng = np.random.RandomState(0)
    b, s, h, d = 2, 64, 4, 16
    q = (rng.randn(b, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, s, h, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, h, d) * 0.5).astype(np.float32)
    vl = np.asarray(valid, np.int32)
    scale = 1.0 / np.sqrt(d)

    def j_body(q, k, v, valid):
        s_loc = k.shape[1]
        start = jax.lax.axis_index("data") * s_loc
        return j_sp.sp_decode_attention(q, k, v, jnp.clip(valid - start, 0, s_loc), scale,
                                        axis="data")

    def t_body(q, k, v, valid):
        s_loc = k.shape[1]
        start = spmd.axis_index("data") * s_loc
        return t_sp.sp_decode_attention(q, k, v, torch.clamp(valid - start, 0, s_loc), scale,
                                        axis="data")

    want = _j_shard_map(j_body, "data", (JP(), JP(None, "data"), JP(None, "data"), JP()),
                        JP())(*map(jnp.asarray, (q, k, v, vl)))
    got = spmd.shard_map(t_body, _mesh("data"),
                         in_specs=(P(), P(None, "data"), P(None, "data"), P()),
                         out_specs=P())(*map(_t, (q, k, v, vl)))
    _close(got, want, 1e-5, "sp_decode_attention")
    full = t_sp.full_decode_attention_ref(*map(_t, (q, k, v, vl)), scale)
    _close(full, j_sp.full_decode_attention_ref(*map(jnp.asarray, (q, k, v, vl)), scale),
           1e-5, "full_decode_attention_ref")
    _close(got, full.numpy(), 1e-5, "sharded against unsharded")


@distributed
def test_sp_decode_attention_counts_each_reduction_site():
    """``psum`` and ``pmax`` reach the recorder one frame deeper than the
    other collectives: each of their call sites still counts once, as in
    the reference's jaxpr (``psum`` twice; its count leaves ``pmax`` out,
    as ``pmax`` is not among its ``_COLLECTIVE_PRIMS``, where the port
    counts the one ``pmax`` site too)."""
    from repro.core import mesh_lower as j_ml
    from repro_torch.core import mesh_lower as t_ml

    rng = np.random.RandomState(1)
    b, s, h, d = 2, 64, 4, 16
    q, k, v = (rng.randn(*sh).astype(np.float32) for sh in ((b, h, d), (b, s, h, d),
                                                           (b, s, h, d)))
    vl = np.asarray([64, 9], np.int32)
    specs = ((JP(), JP(None, "data"), JP(None, "data"), JP()),
             (P(), P(None, "data"), P(None, "data"), P()))
    j_fn = _j_shard_map(lambda *a: j_sp.sp_decode_attention(*a, 0.25, axis="data"), "data",
                        specs[0], JP())
    t_fn = spmd.shard_map(lambda *a: t_sp.sp_decode_attention(*a, 0.25, axis="data"),
                          _mesh("data"), in_specs=specs[1], out_specs=P())
    arrays = dict(q=q, k=k, v=v, valid=vl)
    want = j_ml.count_collectives(j_fn, {n: jnp.asarray(a) for n, a in arrays.items()})
    got = t_ml.count_collectives(t_fn, {n: _t(a) for n, a in arrays.items()})
    assert want == {"psum": 2}
    assert got == {"psum": 2, "pmax": 1}
    assert got.trips == {"psum": 2, "pmax": 1}


@distributed
def test_pipeline_matches_reference_and_the_sequential_loop():
    stages, micro, mb, d = 8, 4, 2, 16
    rng = np.random.RandomState(0)
    ws = (rng.randn(stages, d, d) * 0.3).astype(np.float32)
    x = rng.randn(micro, mb, d).astype(np.float32)

    want = _j_shard_map(
        lambda w, m: j_pipe.pipeline_apply(lambda p, h: jnp.tanh(h @ p), w[0], m, axis="pod"),
        "pod", (JP("pod"), JP()), JP())(jnp.asarray(ws), jnp.asarray(x))
    got = spmd.shard_map(
        lambda w, m: t_pipe.pipeline_apply(lambda p, h: torch.tanh(h @ p), w[0], m, axis="pod"),
        _mesh("pod"), in_specs=(P("pod"), P()), out_specs=P())(_t(ws), _t(x))
    _close(got, want, 1e-5, "pipeline_apply")
    seq = _t(x)
    for i in range(stages):
        seq = torch.tanh(seq @ _t(ws[i]))
    _close(got, seq.numpy(), 1e-5, "against the sequential loop")
    assert t_pipe.bubble_fraction(8, 4) == j_pipe.bubble_fraction(8, 4) == 7 / 11


def _zero1_inputs():
    r = [np.random.RandomState(i) for i in range(4)]
    params = {"w": r[0].randn(33, 7).astype(np.float32), "b": r[1].randn(13).astype(np.float32)}
    grads = {"w": r[2].randn(33, 7).astype(np.float32), "b": r[3].randn(13).astype(np.float32)}
    return params, grads


@distributed
def test_zero1_matches_reference_and_adamw():
    """Two ZeRO-1 steps over 8 ranks against the reference's in shard_map
    (parameters, sharded m and v, grad norm, lr), and the parameters
    against one AdamW of either package."""
    params, grads = _zero1_inputs()
    jcfg = j_adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.01)
    tcfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.01)
    specs = {"m": JP("data"), "v": JP("data"), "step": JP()}
    tspecs = {"m": P("data"), "v": P("data"), "step": P()}
    jfn = _j_shard_map(partial(j_zero1.zero1_update, cfg=jcfg, axis="data"), "data",
                       (JP(), JP(), specs), (JP(), specs, JP()))
    tfn = spmd.shard_map(partial(t_zero1.zero1_update, cfg=tcfg, axis="data"), _mesh("data"),
                         in_specs=(P(), P(), tspecs), out_specs=(P(), tspecs, P()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tp = {k: _t(v) for k, v in params.items()}
    tg = {k: _t(v) for k, v in grads.items()}
    js, ts = j_zero1.zero1_init_state(jp, 8), t_zero1.zero1_init_state(tp, 8)
    for k in ("w", "b"):
        assert tuple(ts["m"][k].shape) == js["m"][k].shape
    for step in range(2):
        jp, js, jinfo = jfn(jp, jg, js)
        tp, ts, tinfo = tfn(tp, tg, ts)
        for k in params:
            _close(tp[k], jp[k], 1e-5, f"step {step} param {k}")
            _close(ts["m"][k], js["m"][k], 1e-5, f"step {step} m {k}")
            _close(ts["v"][k], js["v"][k], 1e-5, f"step {step} v {k}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
        _close(tinfo["grad_norm"], jinfo["grad_norm"], 1e-5, "grad_norm")
        _close(tinfo["lr"], jinfo["lr"], 1e-6, "lr")
        if step == 0:
            ref_p, _, _ = j_adamw.apply_updates(
                {k: jnp.asarray(v) for k, v in params.items()},
                {k: jnp.asarray(v) for k, v in grads.items()},
                j_adamw.init_state({k: jnp.asarray(v) for k, v in params.items()}), jcfg)
            port_p, _, _ = t_adamw.apply_updates(
                {k: _t(v) for k, v in params.items()}, {k: _t(v) for k, v in grads.items()},
                t_adamw.init_state({k: _t(v) for k, v in params.items()}), tcfg)
            for k in params:
                _close(tp[k], ref_p[k], 1e-5, f"zero1 against the reference's adamw {k}")
                _close(tp[k], port_p[k].numpy(), 1e-5, f"zero1 against the port's adamw {k}")


@distributed
def test_zero1_sums_the_ranks_different_shares():
    """Each of 8 ranks holds a different share of the gradient (random
    multiples of 2**-22, the last share the gradient less the others, so
    every partial sum is exact): the port's ZeRO-1 step equals the
    reference's on the same shares, and AdamW on their sum exactly.  A
    reduce-scatter that scaled one rank's share instead of summing the
    shares would miss both."""
    params, _ = _zero1_inputs()
    rng = np.random.RandomState(7)
    unit = 2.0 ** -22
    shares, grads = {}, {}
    for k, p in params.items():
        parts = rng.randint(-2 ** 12, 2 ** 12, (8,) + p.shape).astype(np.int64)
        g = rng.randint(-2 ** 12, 2 ** 12, p.shape)
        parts[-1] = g - parts[:-1].sum(0)
        shares[k] = (parts * unit).astype(np.float32)
        grads[k] = (g * unit).astype(np.float32)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    tcfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    specs = {"m": JP("data"), "v": JP("data"), "step": JP()}
    tspecs = {"m": P("data"), "v": P("data"), "step": P()}

    def j_body(p, sh, st):
        return j_zero1.zero1_update(p, {k: v[0] for k, v in sh.items()}, st, jcfg, "data")

    def t_body(p, sh, st):
        return t_zero1.zero1_update(p, {k: v[0] for k, v in sh.items()}, st, tcfg, "data")

    jfn = _j_shard_map(j_body, "data", (JP(), JP("data"), specs), (JP(), specs, JP()))
    tfn = spmd.shard_map(t_body, _mesh("data"), in_specs=(P(), P("data"), tspecs),
                         out_specs=(P(), tspecs, P()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jp1, _, jinfo = jfn(jp, {k: jnp.asarray(v) for k, v in shares.items()},
                        j_zero1.zero1_init_state(jp, 8))
    tp1, _, tinfo = tfn(tp, {k: _t(v) for k, v in shares.items()},
                        t_zero1.zero1_init_state(tp, 8))
    ap, _, ainfo = t_adamw.apply_updates(tp, {k: _t(v) for k, v in grads.items()},
                                         t_adamw.init_state(tp), tcfg)
    for k in params:
        _close(tp1[k], jp1[k], 1e-5, f"zero1 {k} against the reference's")
        _close(tp1[k], ap[k].numpy(), 1e-6, f"zero1 {k} against adamw on the sum")
    _close(tinfo["grad_norm"], jinfo["grad_norm"], 1e-6, "grad_norm against the reference")
    _close(tinfo["grad_norm"], ainfo["grad_norm"].numpy(), 1e-6, "grad_norm against adamw")


@distributed
def test_compressed_psum_with_error_feedback_matches_reference():
    rng = np.random.RandomState(0)
    g = (rng.randn(8, 2048) * 0.1).astype(np.float32)
    jfn = _j_shard_map(lambda x, r: j_compress.compressed_psum(x, "data", r), "data",
                       (JP("data"), JP("data")), (JP("data"), JP("data")))
    tfn = spmd.shard_map(lambda x, r: t_compress.compressed_psum(x, "data", r), _mesh("data"),
                         in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")))
    jres, tres = jnp.zeros_like(jnp.asarray(g)), torch.zeros(g.shape)
    want = np.broadcast_to(g.sum(0, keepdims=True), g.shape)
    outs = []
    for rnd in range(2):
        jout, jres = jfn(jnp.asarray(g), jres)
        tout, tres = tfn(_t(g), tres)
        # the int8 codes are bit-exact; the sums of 8 dequantized values
        # are float32 sums whose order may differ by a rounding
        _close(tout, jout, 1e-6, f"round {rnd} sum")
        _close(tres, jres, 1e-6, f"round {rnd} residual")
        outs.append(tout.numpy())
    err1 = float(np.max(np.abs(outs[0] - want)))
    err2 = float(np.max(np.abs(outs[0] + outs[1] - 2 * want)))
    assert err1 < 0.05 and err2 <= 2 * err1 + 1e-6
