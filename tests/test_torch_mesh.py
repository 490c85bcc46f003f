"""The port's multi-device compile path against the JAX package's: the
shard planner (``core/shardplan.py``), the partition pass's mesh
annotation under ``hw.with_mesh`` (ROADMAP C13), ``stripe_jit(mesh=)``
with its ``record.mesh`` provenance and collective accounting
(``core/mesh_lower.py``), and the ``mesh-sweep`` space.

Plans, records, reports and scores are framework-neutral and must be
equal.  The ``distributed``-marked tests run the reference's
``stripe_jit(mesh=8)`` on the 8 emulated host devices conftest forces
before jax initializes, and the port's on ``Mesh(["cpu"] * 8, ("x",))``
(eight rank threads on the CPU, where the ``cuda`` backend runs the
kernels' plain versions).  Outputs are float32 and held within
``1e-5 * (1 + max|ref|)`` of the reference's, on the reference's mesh
output where that output agrees with its own single-device compile, and
on the reference's single-device ``stripe_jit(..., backend="jnp")`` for
the three cases whose reference mesh test fails (ROADMAP C0).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mesh_lower as j_ml  # noqa: E402
from repro.core.driver import compile_cached as j_compile  # noqa: E402
from repro.core.driver import stripe_jit as j_jit  # noqa: E402
from repro.core.frontend import TileProgram as JTile  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.core.ir import Block as JBlock  # noqa: E402
from repro.core.ir import ir_fingerprint as j_fp  # noqa: E402
from repro.core.passes import PassManager as JPM  # noqa: E402
from repro.core.passes import compile_program as j_compile_program  # noqa: E402
from repro.core.shardplan import UnsupportedMesh as JUnsupported  # noqa: E402
from repro.core.shardplan import plan_program as j_plan  # noqa: E402
from repro.explore import run_sweep as j_sweep  # noqa: E402
from repro.explore.report import build_report as j_report  # noqa: E402
from repro.explore.space import get_space as j_space  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import mesh_lower as t_ml  # noqa: E402
from repro_torch.core.driver import compile_cached as t_compile  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_jit  # noqa: E402
from repro_torch.core.frontend import TileProgram as TTile  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.core.ir import Block as TBlock  # noqa: E402
from repro_torch.core.ir import ir_fingerprint as t_fp  # noqa: E402
from repro_torch.core.passes import PassManager as TPM  # noqa: E402
from repro_torch.core.passes import compile_program as t_compile_program  # noqa: E402
from repro_torch.core.shardplan import UnsupportedMesh as TUnsupported  # noqa: E402
from repro_torch.core.shardplan import plan_program as t_plan  # noqa: E402
from repro_torch.explore import run_sweep as t_sweep  # noqa: E402
from repro_torch.explore.report import build_report as t_report  # noqa: E402
from repro_torch.explore.space import get_space as t_space  # noqa: E402
from repro_torch.parallel.spmd import Mesh  # noqa: E402

distributed = pytest.mark.distributed
# float32 outputs against the reference's, relative to the largest of them
RTOL = 1e-5


# --------------------------------------------------------------------------
# the programs of tests/test_mesh_lowering.py, built by either frontend
# --------------------------------------------------------------------------
def ffn(tp_cls, m=256, k=64, n=64):
    tp = tp_cls("ffn")
    tp.input("X", (m, k), "float32")
    tp.input("W", (k, n), "float32")
    tp.input("B", (n,), "float32")
    tp.output("O", (m, n), "float32")
    tp.temp("T", (m, n), "float32")
    tp.temp("U", (m, n), "float32")
    tp.op("T[i, j] += X[i, c] * W[c, j]", name="mm")
    tp.op("U[i, j] = T[i, j] + B[j]", name="bias")
    tp.op("O[i, j] = gelu(U[i, j])", name="act")
    return tp.build()


def matmul(tp_cls, m, k, n):
    tp = tp_cls("mm")
    tp.input("X", (m, k), "float32")
    tp.input("W", (k, n), "float32")
    tp.output("O", (m, n), "float32")
    tp.op("O[i, j] += X[i, c] * W[c, j]", name="mm")
    return tp.build()


def halo_conv(tp_cls, x=32, y=15, c=5, k=7):
    tp = tp_cls("conv")
    tp.input("I", (x, y, c), "float32")
    tp.input("F", (3, 3, c, k), "float32")
    tp.output("O", (x, y, k), "float32")
    tp.op("O[x, y, k] += I[x + i - 1, y + j - 1, c] * F[i, j, c, k]", name="conv")
    return tp.build()


def mlp2(tp_cls, m=12, c=24, h=4096, f=64):
    tp = tp_cls("mlp2")
    tp.input("X", (m, c), "float32")
    tp.input("W1", (c, h), "float32")
    tp.input("W2", (h, f), "float32")
    tp.output("O", (m, f), "float32")
    tp.temp("H", (m, h), "float32")
    tp.op("H[i, h] += X[i, c] * W1[c, h]", name="mm1")
    tp.op("O[i, f] += H[i, h] * W2[h, f]", name="mm2")
    return tp.build()


PROGRAMS = {
    "ffn": lambda tp: ffn(tp),
    "psum": lambda tp: matmul(tp, 12, 64, 20),
    "halo_conv": lambda tp: halo_conv(tp),
    "mlp2": lambda tp: mlp2(tp),
    "mm64": lambda tp: matmul(tp, 64, 32, 48),
    "indivisible": lambda tp: matmul(tp, 13, 7, 5),
}
MESHES = [(2,), (4,), (8,), (2, 4)]


def _slow(hw):
    """The reference test's config under which the ring overlap wins."""
    return dataclasses.replace(hw, ici_link_bw=1e7, peak_flops=1e8)


def _hws(name):
    if name == "tpu_v5e_slow":
        return _slow(j_hw("tpu_v5e")), _slow(t_hw("tpu_v5e"))
    return j_hw(name), t_hw(name)


def _arrays(prog, seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=prog.buffers[name].shape).astype("float32")
            for name in prog.inputs}


def _cpu_mesh(n=8):
    return Mesh(["cpu"] * n, ("x",))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    bound = RTOL * (1.0 + float(np.max(np.abs(want))))
    assert err <= bound, f"{what}: max|port - ref| {err:.3e} > {bound:.3e}"
    return err


def _plan_view(plan):
    return {
        "n": plan.n, "seed": plan.seed, "steps": repr(plan.steps),
        "splits": plan.splits(), "in_specs": dict(plan.in_specs),
        "collectives": [c.to_json() for c in plan.collectives],
        "collective_bytes": plan.collective_bytes(), "comm_s": plan.comm_s,
        "compute_s": plan.compute_s, "cost_s": plan.cost_s,
        "report": plan.report(), "report_unscaled": plan.report(scale_compute=False),
    }


# --------------------------------------------------------------------------
# shardplan: the copy plans as the reference does (no devices)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hw", ["cpu_test", "tpu_v5e", "tpu_v5e_slow"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_shard_plan_equals_reference(name, shape, hw):
    jh, th = _hws(hw)
    n = int(np.prod(shape))
    jprog, tprog = PROGRAMS[name](JTile), PROGRAMS[name](TTile)
    try:
        jplan = j_plan(jprog, n, jh, shape)
    except JUnsupported as e:
        with pytest.raises(TUnsupported) as got:
            t_plan(tprog, n, th, shape)
        assert str(got.value) == str(e)
        return
    tplan = t_plan(tprog, n, th, shape)
    assert _plan_view(tplan) == _plan_view(jplan)
    jsegs, tsegs = jplan.build_segments(jprog), tplan.build_segments(tprog)
    assert [t_fp(s.program) for s in tsegs] == [j_fp(s.program) for s in jsegs]
    assert [(s.inputs, s.outputs) for s in tsegs] == [(s.inputs, s.outputs) for s in jsegs]


# --------------------------------------------------------------------------
# C13: the partition pass under hw.with_mesh
# --------------------------------------------------------------------------
def _partition_view(opt, trace, block_cls):
    report = [e for e in trace if e[0] == "partition"]
    tags = {s.name: sorted(t for t in s.tags if t.startswith("partition"))
            for s in opt.entry.stmts if isinstance(s, block_cls)}
    return json.loads(json.dumps(report, default=str)), tags


@pytest.mark.parametrize("hw", ["cpu_test", "tpu_v5e"])
@pytest.mark.parametrize("shape", [(4,), (8,), (2, 4)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["mm64", "ffn", "psum", "halo_conv", "indivisible"])
def test_partition_pass_under_a_mesh_reports_as_reference_c13(name, shape, hw):
    """Every compile under a meshed config crashed with ``ModuleNotFoundError:
    No module named 'repro_torch.core.shardplan'`` (C13).  Now both
    packages' ``compile_program`` tag the same blocks ``partition:<idx>:<n>``
    and report the same plan (``plan.report(scale_compute=True)``)."""
    jh, th = (h.with_mesh(shape) for h in _hws(hw))
    jprog, tprog = PROGRAMS[name](JTile), PROGRAMS[name](TTile)
    jopt = j_compile_program(jprog, jh)
    topt = t_compile_program(tprog, th)
    assert t_fp(topt) == j_fp(jopt)
    jpm, tpm = JPM(jh), TPM(th)
    jv = _partition_view(jpm.run(PROGRAMS[name](JTile)), jpm.trace, JBlock)
    tv = _partition_view(tpm.run(PROGRAMS[name](TTile)), tpm.trace, TBlock)
    assert tv == jv
    assert jv[0] and jv[0][0][2], "the pass reports the plan (or its fallback)"
    if name != "indivisible":
        assert any(t for t in tv[1].values()), "a split shows on the optimized blocks"


@pytest.mark.parametrize("name", ["ffn", "halo_conv", "indivisible"])
def test_compile_cached_under_a_mesh_scores_as_reference(name):
    from repro.core.cost import score_pass_trace as j_score
    from repro_torch.core.cost import score_pass_trace as t_score

    jh, th = j_hw("tpu_v5e").with_mesh((8,)), t_hw("tpu_v5e").with_mesh((8,))
    _, jrec = j_compile(PROGRAMS[name](JTile), jh)
    _, trec = t_compile(PROGRAMS[name](TTile), th)
    assert dataclasses.asdict(t_score(trec.pass_trace, trec.n_kernels)) == \
        dataclasses.asdict(j_score(jrec.pass_trace, jrec.n_kernels))


# --------------------------------------------------------------------------
# stripe_jit(mesh=) against the reference's, 8 ranks
# --------------------------------------------------------------------------
MESH_KEYS = ("shape", "axis", "n_devices", "seed", "splits", "collectives",
             "collective_bytes", "comm_s", "compute_s", "overlapped")


def _mesh_view(mesh_info):
    view = {k: mesh_info.get(k) for k in MESH_KEYS}
    view["n_segments"] = len(mesh_info.get("segments", ()))
    view["segment_names"] = [s["name"] for s in mesh_info.get("segments", ())]
    return json.loads(json.dumps(view))


def _pair(name, hw="cpu_test", backend="torch", mesh=None):
    jh, th = _hws(hw)
    jc = j_jit(PROGRAMS[name](JTile), jh, backend="jnp", mesh=8)
    tc = t_jit(PROGRAMS[name](TTile), th, backend,
               cache=t_cache.CompilationCache(use_disk=False), use_disk=False,
               mesh=mesh or _cpu_mesh())
    return jc, tc


def _t_arrays(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@distributed
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["ffn", "psum"])
def test_mesh_compile_matches_the_reference_mesh(name, backend):
    """Output split (ffn: a row split and a gather) and reduction split (a
    psum): ``record.mesh`` equals the reference's, the output holds to
    the reference's mesh output, and the collective call sites equal the
    plan's and the reference's jaxpr counts."""
    jc, tc = _pair(name, backend=backend)
    assert _mesh_view(tc.record.mesh) == _mesh_view(jc.record.mesh)
    assert tc.record.backend == backend
    assert all(s["backend"] == backend for s in tc.record.mesh["segments"])
    arrays = _arrays(PROGRAMS[name](JTile))
    _close(tc(_t_arrays(arrays))["O"], jc(arrays)["O"], name)
    counts = t_ml.count_collectives(tc, _t_arrays(arrays))
    assert counts == t_ml.expected_primitive_counts_from_record(tc.record.mesh)
    assert counts == j_ml.count_collectives(jc._fn, arrays)
    assert t_ml.expected_primitive_counts_from_record(tc.record.mesh) == \
        j_ml.expected_primitive_counts_from_record(jc.record.mesh)


def _c0_case(name, hw, arrays_seed=0, **prog_kw):
    """A case whose reference mesh test fails (ROADMAP C0): the port's
    mesh output is held to the reference's single-device jnp compile."""
    jh, th = _hws(hw)
    jprog = (halo_conv(JTile, **prog_kw) if name == "halo_conv" else PROGRAMS[name](JTile))
    tprog = (halo_conv(TTile, **prog_kw) if name == "halo_conv" else PROGRAMS[name](TTile))
    jc = j_jit(jprog, jh, backend="jnp", mesh=8)
    ref = j_jit(jprog, j_hw("cpu_test"), backend="jnp")
    tc = t_jit(tprog, th, "torch", cache=t_cache.CompilationCache(use_disk=False),
               use_disk=False, mesh=_cpu_mesh())
    assert _mesh_view(tc.record.mesh) == _mesh_view(jc.record.mesh)
    arrays = _arrays(jprog, arrays_seed)
    _close(tc(_t_arrays(arrays))["O"], ref(arrays)["O"], name)
    counts = t_ml.count_collectives(tc, _t_arrays(arrays))
    assert counts == t_ml.expected_primitive_counts_from_record(tc.record.mesh)
    assert counts == j_ml.count_collectives(jc._fn, arrays)
    return tc


@distributed
def test_halo_conv_mesh_holds_to_the_single_device_reference():
    """ROADMAP C0: the reference's ``test_halo_conv_bit_exact`` misses bit
    equality with its own single-device compile by ~3e-6, so the port's
    halo-split conv (a ppermute pair, zero-filled at the ends, and a
    gather) is held to the reference's single-device ``jnp`` output at
    ``RTOL``, its plan and record to the reference's mesh compile."""
    tc = _c0_case("halo_conv", "cpu_test")
    ops = sorted(c["collective"] for c in tc.record.mesh["collectives"])
    assert ops == ["all_gather", "halo"]


@distributed
@pytest.mark.parametrize("x,y,c", [(16, 9, 3), (32, 15, 5), (16, 15, 5), (32, 9, 3)])
def test_property_halo_conv_holds_to_the_single_device_reference(x, y, c):
    """The reference's ``test_property_halo_conv_bit_exact`` fails as its
    bit-exact test does (ROADMAP C0): the same shapes, held to the
    reference's single-device ``jnp`` output at ``RTOL``."""
    _c0_case("halo_conv", "cpu_test", arrays_seed=x + y + c, x=x, y=y, c=c, k=4)


@distributed
def test_ring_overlap_holds_to_the_single_device_reference():
    """ROADMAP C0: the reference's ring (chosen by cost on slow links)
    misses its own single-device output at ``rtol=1e-4`` by one element
    of 768, so the port's ring is held to the reference's single-device
    ``jnp`` output at ``RTOL`` of the output's scale (float32 sums of 4096
    products taken in another order), its plan to the reference's."""
    tc = _c0_case("mlp2", "tpu_v5e_slow")
    assert tc.record.mesh["overlapped"] == ["O"]
    assert "ring_matmul" in [c["collective"] for c in tc.record.mesh["collectives"]]


@distributed
def test_mesh_fallback_records_the_reference_reason():
    jc, tc = _pair("indivisible")
    assert tc.record.mesh == jc.record.mesh
    assert "divisible" in tc.record.mesh["fallback"]
    arrays = _arrays(PROGRAMS["indivisible"](JTile))
    _close(tc(_t_arrays(arrays))["O"], jc(arrays)["O"])
    assert t_ml.count_collectives(tc, _t_arrays(arrays)) == {}


@distributed
def test_mesh_shape_tuple_records_as_reference():
    """A 2-D mesh of 8 ranks (``api.Mesh`` over a (2, 4) array of devices)
    flattens to one execution axis, as the reference's ``mesh=(2, 4)``."""
    jc = j_jit(ffn(JTile), j_hw("cpu_test"), backend="jnp", mesh=(2, 4))
    devs = np.empty(8, dtype=object)
    devs[:] = ["cpu"] * 8
    tc = api.jit(ffn(TTile), t_hw("cpu_test"), "torch", use_disk=False,
                 cache=t_cache.CompilationCache(use_disk=False),
                 mesh=api.Mesh(devs.reshape(2, 4), ("data", "model")))
    assert tc.record.mesh["shape"] == [2, 4]
    assert _mesh_view(tc.record.mesh) == _mesh_view(jc.record.mesh)
    arrays = _arrays(ffn(JTile))
    _close(tc(_t_arrays(arrays))["O"], jc(arrays)["O"])


def test_mesh_compile_memory_cache_hit():
    cache = t_cache.CompilationCache(use_disk=False)
    c1 = t_jit(ffn(TTile), t_hw("cpu_test"), "torch", cache=cache, use_disk=False,
               mesh=_cpu_mesh())
    c2 = t_jit(ffn(TTile), t_hw("cpu_test"), "torch", cache=cache, use_disk=False,
               mesh=_cpu_mesh())
    assert not c1.record.cache_hit and c2.record.cache_hit
    assert c2.record.mesh == c1.record.mesh
    arrays = _t_arrays(_arrays(ffn(JTile)))
    assert torch.equal(c2(arrays)["O"], c1(arrays)["O"])
    # the same shape over other devices is another artifact
    c3 = t_jit(ffn(TTile), t_hw("cpu_test"), "torch", cache=cache, use_disk=False,
               mesh=Mesh(["cpu"] * 4 + ["cpu:0"] * 4, ("x",)))
    assert not c3.record.cache_hit


def test_mesh_count_or_shape_needs_that_many_cards():
    """``mesh=8`` takes the machine's first 8 cards; with fewer it raises
    with the reference's message, adapted (explicit devices emulate
    them), and never runs on the CPU."""
    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match="explicit devices"):
        t_ml.resolve_mesh(n)
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        t_jit(ffn(TTile), t_hw("cpu_test"), "torch", mesh=n)
    assert t_ml.resolve_mesh(1) is None and t_ml.resolve_mesh(None) is None
    mesh, axis, shape = t_ml.resolve_mesh(Mesh(["cpu"] * 4, ("dev",)))
    assert (axis, shape, mesh.size) == ("dev", (4,), 4)


def test_expected_counts_equal_reference_on_every_plan():
    for name in ("ffn", "psum", "halo_conv", "mlp2", "mm64"):
        for hw in ("cpu_test", "tpu_v5e_slow"):
            jh, th = _hws(hw)
            jplan = j_plan(PROGRAMS[name](JTile), 8, jh, (8,))
            tplan = t_plan(PROGRAMS[name](TTile), 8, th, (8,))
            assert t_ml.expected_primitive_counts(tplan) == j_ml.expected_primitive_counts(jplan)


# --------------------------------------------------------------------------
# mesh-sweep
# --------------------------------------------------------------------------
def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in ("wall_time_s", "compile_time_s")}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def test_mesh_sweep_scores_and_ranks_as_reference(tmp_path):
    """The port's ``mesh-sweep`` scores every point through the partition
    pass (no device touched) as the reference does: equal points, scores,
    communication bytes and Pareto ranking."""
    kw = dict(budget=5, strategy="grid", measure_top_k=0, parallel=False)
    js = j_sweep(j_space("mesh-sweep"), "default", cache_dir=str(tmp_path / "j"), **kw)
    ts = t_sweep(t_space("mesh-sweep"), "default", cache_dir=str(tmp_path / "t"), **kw)
    assert [p.fingerprint for p in ts.points] == [p.fingerprint for p in js.points]
    jdoc, tdoc = _strip_times(j_report(js)), _strip_times(t_report(ts))
    assert json.dumps(tdoc, sort_keys=True, default=str) == \
        json.dumps(jdoc, sort_keys=True, default=str)
    meshed = [p for p in tdoc["points"]
              if p["point"].get("mesh", (1,)) not in ((1,), [1])
              and not p["error"] and p["dedup_of"] is None]
    assert meshed and all(p["comm_bytes"] > 0 for p in meshed)


def test_windowed_plain_reads_an_input_view_at_its_offset_c14():
    """ROADMAP C14: a rank's shard of a row-split input is a view into the
    global tensor (``narrow`` on dim 0: contiguous, storage offset > 0).
    The windowed kernel's plain version indexed the storage from 0, so the
    boundary pieces of a ragged tiling read another rank's rows (the psum
    of a 255 x 14336 x 4095 down projection was off by the output's
    scale).  A view now gives what its copy gives, and the reference's
    output on the same numbers."""
    prog = matmul(TTile, 255, 64, 4095)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(255, 64)).astype("float32")
    big = rng.normal(size=(64 + 9, 4095)).astype("float32")
    c = t_jit(prog, t_hw("h100"), "cuda", cache=t_cache.CompilationCache(use_disk=False),
              use_disk=False)
    assert len(c.record.block_backends) == 1 and c.record.n_kernels > 1  # boundary pieces
    view = torch.from_numpy(big).narrow(0, 9, 64)
    assert view.is_contiguous() and view.storage_offset() > 0
    got = c({"X": torch.from_numpy(x), "W": view})["O"]
    assert torch.equal(got, c({"X": torch.from_numpy(x), "W": view.clone()})["O"])
    want = j_jit(matmul(JTile, 255, 64, 4095), j_hw("cpu_test"), backend="jnp")(
        {"X": x, "W": big[9:]})["O"]
    _close(got, want, "view against the reference")


@distributed
def test_fault_plans_leave_the_mesh_compile_alone_c16():
    """ROADMAP C16: the reference's mesh compile checks the fault site
    ``compile.stripe_jit_mesh``, which its registry lacks, so under any
    active fault plan it falls back to one device ("unregistered site").
    The port registers the site: an unrelated plan leaves the plan as it
    is, and a fault injected at the site falls back with its reason."""
    from repro.reliability import faults as j_faults
    from repro_torch.reliability import faults as t_faults

    with j_faults.inject(j_faults.fail_nth("serve.decode_step", 1)):
        jc = j_jit(PROGRAMS["mm64"](JTile), j_hw("cpu_test"), backend="jnp", mesh=8,
                   use_disk=False)
    assert "unregistered site" in jc.record.mesh["fallback"]
    kw = dict(cache=t_cache.CompilationCache(use_disk=False), use_disk=False, mesh=_cpu_mesh())
    with t_faults.inject(t_faults.fail_nth("serve.decode_step", 1)):
        tc = t_jit(PROGRAMS["mm64"](TTile), t_hw("cpu_test"), "torch", **kw)
    assert "fallback" not in tc.record.mesh and tc.record.mesh["splits"] == {"mm": "i"}
    with t_faults.inject(t_faults.fail_nth("compile.stripe_jit_mesh", 1)):
        tc = t_jit(PROGRAMS["mm64"](TTile), t_hw("cpu_test"), "torch", **kw)
    assert "injected fault at compile.stripe_jit_mesh" in tc.record.mesh["fallback"]
    arrays = _arrays(PROGRAMS["mm64"](JTile))
    _close(tc(_t_arrays(arrays))["O"], arrays["X"] @ arrays["W"])
