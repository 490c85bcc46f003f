"""The port's measured-feedback tuning (``repro_torch.tune``) against the
JAX package's: the twins of ``tests/test_tune.py``'s cases — the
persistent tuning DB (round-trip, min-wins, freshness, thread and process
concurrency, torn-write and corrupt-file recovery), the driver's tuned
replay and fixed-tiling replay, the measure mode, the IRLS calibration fit
and the calibration rekey, the residual log's rotation into the DB, and the
serving engine's ``tune`` on and off — run on the CPU, where the ``cuda``
backend runs each kernel's plain version.

The DB's ``interpret`` slot is the reference's: there "ran in Pallas
interpret mode", here "the plain versions ran" (no tensor of the call on
the card).  So everything measured here lands with ``interpret`` true,
and ``stripe_jit(..., device="cuda")`` never replays it.

Exact parity checks: ``entry_key`` and ``candidate_id`` are equal across
the packages for the same program; a DB written by either package loads
in the other; and ``python -m repro_torch.obs`` prints what ``python -m
repro.obs`` prints for the same trace and residual files.
"""
import json
import multiprocessing
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core.driver import compile_cached as j_compile  # noqa: E402
from repro.core.frontend import single_op_program as j_single  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.models.build import build_model as j_build  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.obs.__main__ import main as j_obs_cli  # noqa: E402
from repro.tune import TuningDB as JTuningDB  # noqa: E402
from repro.tune import candidate_id as j_candidate_id  # noqa: E402
from repro.tune import entry_key as j_entry_key  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.cache import CompilationCache  # noqa: E402
from repro_torch.core.cost import evaluate_tiling  # noqa: E402
from repro_torch.core.driver import compile_cached as t_compile  # noqa: E402
from repro_torch.core.frontend import single_op_program  # noqa: E402
from repro_torch.core.hwconfig import get_config  # noqa: E402
from repro_torch.explore.runner import _random_arrays, unit_plan  # noqa: E402
from repro_torch.obs import profile as t_profile  # noqa: E402
from repro_torch.obs.__main__ import main as t_obs_cli  # noqa: E402
from repro_torch.obs.profile import (append_residuals, read_residuals,  # noqa: E402
                                     summarize_residuals)
from repro_torch.reliability import faults  # noqa: E402
from repro_torch.tune import (Calibration, TuningDB, candidate_id,  # noqa: E402
                              clear_calibrations, entry_key, fit_calibration,
                              get_calibration, load_calibrations, measure_interleaved,
                              save_calibrations, set_calibration)

MM = ("O[i, j] += A[i, c] * B[c, j]",
      {"A": ((32, 16), "float32"), "B": ((16, 24), "float32"), "O": ((32, 24), "float32")})


def _mm():
    return single_op_program(MM[0], MM[1], out="O")


def _mm_arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"A": torch.from_numpy(rng.randn(32, 16).astype(np.float32)),
            "B": torch.from_numpy(rng.randn(16, 24).astype(np.float32))}


def _jit(prog, hw, **kw):
    """The port's compile for CPU tensors (the kernels' plain versions)."""
    return api.stripe_jit(prog, hw, device="cpu", **kw)


# --------------------------------------------------------------------------
# TuningDB basics
# --------------------------------------------------------------------------
def test_db_record_lookup_roundtrip(tmp_path):
    db = TuningDB(dir=tmp_path)
    tilings = {"mm#abc": {"i": 8, "j": 8}}
    cid = db.record("ir1", "hw1", "cuda", False, tilings=tilings,
                    measured_s=2e-3, predicted_s=1e-3, rounds=4, calls=2,
                    source="test", workload="mm")
    assert len(db) == 1
    e = db.lookup("ir1", "hw1", "cuda", False)
    assert e is not None and e.candidate_id == cid
    assert e.tilings == tilings and e.measured_s == 2e-3
    assert e.source == "test" and e.workload == "mm" and e.rounds == 4
    # identity is the full (ir, hw, backend, interpret) tuple
    assert db.lookup("ir1", "hw1", "cuda", True) is None
    assert db.lookup("ir1", "hw2", "cuda", False) is None
    assert db.lookup("other", "hw1", "cuda", False) is None
    # a fresh handle over the same dir sees the same entry
    e2 = TuningDB(dir=tmp_path).lookup("ir1", "hw1", "cuda", False)
    assert e2 is not None and e2.candidate_id == cid


def test_db_best_candidate_min_wins(tmp_path):
    db = TuningDB(dir=tmp_path)
    slow = {"mm#abc": {"i": 4}}
    fast = {"mm#abc": {"i": 16}}
    db.record("ir", "hw", "torch", True, tilings=slow, measured_s=5e-3)
    db.record("ir", "hw", "torch", True, tilings=fast, measured_s=1e-3)
    assert db.lookup("ir", "hw", "torch", True).tilings == fast
    # re-measuring an existing candidate keeps the minimum
    db.record("ir", "hw", "torch", True, tilings=fast, measured_s=9e-3)
    e = db.lookup("ir", "hw", "torch", True)
    assert e.tilings == fast and e.measured_s == 1e-3
    # a new measurement below the floor takes over
    db.record("ir", "hw", "torch", True, tilings=slow, measured_s=5e-4)
    assert db.lookup("ir", "hw", "torch", True).tilings == slow


def test_db_freshness_bound(tmp_path):
    db = TuningDB(dir=tmp_path)
    db.record("ir", "hw", "torch", True, tilings={"b#x": {"i": 4}}, measured_s=1e-3)
    assert db.lookup("ir", "hw", "torch", True, max_age_s=3600) is not None
    # everything is staler than a negative bound
    assert db.lookup("ir", "hw", "torch", True, max_age_s=-1.0) is None
    # the DB-level default applies when the call doesn't override
    stale_db = TuningDB(dir=tmp_path, max_age_s=-1.0)
    assert stale_db.lookup("ir", "hw", "torch", True) is None
    assert stale_db.lookup("ir", "hw", "torch", True, max_age_s=3600) is not None


# --------------------------------------------------------------------------
# TuningDB concurrency + durability
# --------------------------------------------------------------------------
def test_db_thread_concurrency_no_lost_entries(tmp_path):
    db = TuningDB(dir=tmp_path)
    n = 8

    def worker(i):
        db.record("ir", "hw", "torch", True, tilings={"b#x": {"i": i + 1}},
                  measured_s=float(i + 1), source=f"thread{i}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    entry = db.entries()[entry_key("ir", "hw", "torch", True)]
    assert len(entry["candidates"]) == n, "concurrent records must not lose"
    assert db.lookup("ir", "hw", "torch", True).measured_s == 1.0


def _record_in_subprocess(args):
    # module-level so the spawned pool can unpickle it by import path
    d, i = args
    TuningDB(dir=d).record("ir", "hw", "torch", True, tilings={"b#x": {"i": i + 1}},
                           measured_s=float(i + 1), source=f"proc{i}")
    return i


def test_db_process_concurrency_no_lost_entries(tmp_path):
    n = 8
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        done = pool.map(_record_in_subprocess, [(str(tmp_path), i) for i in range(n)])
    assert sorted(done) == list(range(n))
    entry = TuningDB(dir=tmp_path).entries()[entry_key("ir", "hw", "torch", True)]
    assert len(entry["candidates"]) == n, "cross-process records must not lose"


def test_db_torn_write_recovered(tmp_path):
    db = TuningDB(dir=tmp_path)
    with faults.inject(faults.fail_nth("cache.disk_write_torn", 1)):
        db.record("ir", "hw", "torch", True, tilings={"b#x": {"i": 4}}, measured_s=1e-3)
    assert db.write_errors == 1
    # the torn document landed at the final path
    with pytest.raises(json.JSONDecodeError):
        json.loads((tmp_path / "tuning_db.json").read_text())
    # a fresh handle recovers (moves the wreck aside) instead of raising
    db2 = TuningDB(dir=tmp_path)
    assert len(db2) == 0 and db2.recovered == 1
    assert (tmp_path / "tuning_db.corrupt").exists()
    # and the DB is immediately writable again
    db2.record("ir", "hw", "torch", True, tilings={"b#x": {"i": 4}}, measured_s=1e-3)
    assert db2.lookup("ir", "hw", "torch", True).measured_s == 1e-3


def test_corrupt_db_never_fails_the_compile(tmp_path):
    (tmp_path / "tuning_db.json").write_text("{definitely not json")
    db = TuningDB(dir=tmp_path)
    cache = CompilationCache(disk_dir=tmp_path)
    c = _jit(_mm(), get_config("cpu_test"), cache=cache, tune=db)
    assert c.record.decision_source == "analytic"
    assert db.recovered >= 1
    assert c(_mm_arrays())["O"].shape == (32, 24)


# --------------------------------------------------------------------------
# driver integration: tuned replay
# --------------------------------------------------------------------------
def _halved(tilings):
    return {k: {v: max(1, t // 2) for v, t in tiles.items()} for k, tiles in tilings.items()}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_stripe_jit_tuned_replay(tmp_path, backend):
    hw = get_config("cpu_test")
    cache = CompilationCache(disk_dir=tmp_path)
    db = TuningDB(dir=tmp_path)
    c1 = _jit(_mm(), hw, backend=backend, cache=cache, tune=db)
    assert c1.record.decision_source == "analytic" and not c1.record.tuned
    assert cache.stats.tuned_misses == 1 and cache.stats.tuned_hits == 0
    # record a measured winner with a deliberately different tiling
    alt = _halved(c1.record.tilings)
    assert alt != c1.record.tilings
    cid = db.record(c1.record.ir_fingerprint, c1.record.hw_fingerprint,
                    backend, True, tilings=alt, measured_s=1e-4,
                    predicted_s=2e-4, rounds=4, source="test")
    # a fresh cache instance over the same disk dir = a new process
    cache2 = CompilationCache(disk_dir=tmp_path)
    c2 = _jit(_mm(), hw, backend=backend, cache=cache2, tune=db)
    assert c2.record.decision_source == "tuned"
    assert c2.record.tuned["candidate_id"] == cid
    assert c2.record.tuned["source"] == "test"
    assert c2.record.tilings == alt, "replay must compile the measured tiling"
    assert cache2.stats.tuned_hits == 1
    # different tiling, same math
    arrays = _mm_arrays()
    torch.testing.assert_close(c1(arrays)["O"], c2(arrays)["O"], rtol=1e-5, atol=1e-5)
    # second compile in the same process: memory hit under the tuned key
    c3 = _jit(_mm(), hw, backend=backend, cache=cache2, tune=db)
    assert c3.record.cache_hit and c3.record.decision_source == "tuned"
    assert cache2.stats.tuned_hits == 2


def test_a_plain_version_measurement_is_never_replayed_for_the_card(tmp_path):
    """An entry measured on CPU tensors (``interpret`` true) serves
    ``device="cpu"`` compiles only; a card entry serves ``"cuda"`` only."""
    hw = get_config("cpu_test")
    db = TuningDB(dir=tmp_path)
    c0 = _jit(_mm(), hw, cache=CompilationCache(use_disk=False), use_disk=False)
    rec = c0.record
    db.record(rec.ir_fingerprint, rec.hw_fingerprint, "cuda", True,
              tilings=_halved(rec.tilings), measured_s=1e-4, source="cpu")
    card = api.stripe_jit(_mm(), hw, "cuda", cache=CompilationCache(use_disk=False),
                          use_disk=False, tune=db, device="cuda")
    assert card.record.decision_source == "analytic"
    cpu = _jit(_mm(), hw, cache=CompilationCache(use_disk=False), use_disk=False, tune=db)
    assert cpu.record.decision_source == "tuned" and cpu.record.tuned["source"] == "cpu"
    db.record(rec.ir_fingerprint, rec.hw_fingerprint, "cuda", False,
              tilings=rec.tilings, measured_s=2e-6, source="card")
    card = api.stripe_jit(_mm(), hw, "cuda", cache=CompilationCache(use_disk=False),
                          use_disk=False, tune=db, device="cuda")
    assert card.record.decision_source == "tuned" and card.record.tuned["source"] == "card"
    with pytest.raises(ValueError, match="device"):
        api.stripe_jit(_mm(), hw, "cuda", device="gpu")


def test_a_tuned_unit_recorded_on_torch_is_lowered_afresh(tmp_path):
    """A unit an entry recorded as ``torch`` under ``cuda`` is not kept off
    its kernel by the record: legality is decided afresh under the
    replayed tilings, and the change is listed on the record."""
    hw = get_config("cpu_test")
    c1 = _jit(_mm(), hw, cache=CompilationCache(use_disk=False), use_disk=False)
    (unit,) = c1.record.block_backends
    assert c1.record.block_backends[unit] == "cuda"
    db = TuningDB(dir=tmp_path)
    db.record(c1.record.ir_fingerprint, c1.record.hw_fingerprint, "cuda", True,
              tilings=c1.record.tilings, block_backends={unit: "torch"}, measured_s=1e-4)
    c2 = _jit(_mm(), hw, cache=CompilationCache(use_disk=False), use_disk=False, tune=db)
    assert c2.record.decision_source == "tuned"
    assert c2.record.backend == "cuda" and c2.record.block_backends == {unit: "cuda"}
    assert c2.record.tuned["backend_changed"] == {unit: {"entry": "torch", "now": "cuda"}}
    arrays = _mm_arrays()
    torch.testing.assert_close(c1(arrays)["O"], c2(arrays)["O"], rtol=1e-5, atol=1e-5)
    # an entry that agrees with the fresh lowering lists nothing
    db.record(c1.record.ir_fingerprint, c1.record.hw_fingerprint, "cuda", True,
              tilings=c1.record.tilings, block_backends={unit: "cuda"}, measured_s=1e-5)
    c3 = _jit(_mm(), hw, cache=CompilationCache(use_disk=False), use_disk=False, tune=db)
    assert c3.record.decision_source == "tuned" and c3.record.tuned["backend_changed"] == {}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_compile_with_tilings_fixed_replay(backend):
    hw = get_config("cpu_test")
    c1 = _jit(_mm(), hw, use_disk=False, cache=CompilationCache(use_disk=False))
    alt = _halved(c1.record.tilings)
    c2 = api.compile_with_tilings(_mm(), hw, alt, backend=backend)
    assert c2.record.decision_source == "replay"
    assert c2.record.tilings == alt
    arrays = _mm_arrays()
    torch.testing.assert_close(c1(arrays)["O"], c2(arrays)["O"], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the interpret flag of profiled calls (what the residual rows and the DB say)
# --------------------------------------------------------------------------
def test_a_cpu_call_logs_interpret_true(tmp_path):
    cache = CompilationCache(disk_dir=tmp_path)
    db = TuningDB(dir=tmp_path)
    c = _jit(_mm(), get_config("cpu_test"), cache=cache, profile=True, tune=db)
    c(_mm_arrays())
    rows = read_residuals(t_profile.residual_log_path(cache))
    assert rows and all(r["interpret"] is True for r in rows)
    # profiled traffic populates the DB, in the plain versions' slot
    e = db.lookup(c.record.ir_fingerprint, c.record.hw_fingerprint, "cuda", True)
    assert e is not None and e.source == "profile"
    assert db.lookup(c.record.ir_fingerprint, c.record.hw_fingerprint, "cuda", False) is None


# --------------------------------------------------------------------------
# measure mode (explore integration)
# --------------------------------------------------------------------------
def test_measure_interleaved_min_of_rounds():
    calls = {"a": 0, "b": 0}

    def mk(name):
        def thunk():
            calls[name] += 1
        return thunk

    ms = measure_interleaved({"a": mk("a"), "b": mk("b")}, rounds=3, calls=2, warmup=1)
    assert set(ms) == {"a", "b"}
    for m in ms.values():
        assert m.rounds == 3 and m.calls == 2
        assert m.min_s == min(m.all_rounds_s) > 0
    # warmup + rounds * calls per thunk
    assert calls == {"a": 7, "b": 7}


def test_measure_candidates_populates_db(tmp_path):
    from repro_torch.explore import Axis, SearchSpace

    sp = SearchSpace(name="tiny-cpu", base="cpu_test",
                     axes=(Axis("mem.RAM.bandwidth", (50e9, 200e9), default=50e9),))
    db = TuningDB(dir=tmp_path)
    sweep = api.run_sweep(sp, "fig4_conv", budget=2, strategy="grid",
                          cache_dir=str(tmp_path / "cache"), measure=3, tune_db=db,
                          measure_device="cpu")
    ms = sweep.measurement
    assert ms is not None and ms["backend"] == "cuda" and ms["interpret"]
    assert ms["device"] == "cpu"
    wl = ms["workloads"]["fig4_conv"]
    assert not wl.get("error")
    assert wl["n_candidates"] >= 2
    assert 1 <= wl["n_distinct_plans"] <= wl["n_candidates"]
    assert wl["best_s"] <= wl["analytic_s"], \
        "the analytic tiling is candidate 0, so the min can't lose to it"
    assert len(db) == 1
    e = next(iter(db.entries().values()))
    assert e["backend"] == "cuda" and e["interpret"] is True and e["workload"] == "fig4_conv"
    assert len(e["candidates"]) == wl["n_candidates"]
    assert e["best"] == wl["best_candidate"]
    # the recorded winner replays through the tuned compile path
    hw = sp.base_config()
    c = _jit(api.get_workloads("fig4_conv")[0].build(), hw,
             cache=CompilationCache(disk_dir=tmp_path / "cache"), tune=db)
    assert c.record.decision_source == "tuned"
    assert c.record.tuned["candidate_id"] == wl["best_candidate"]


def test_measure_candidates_plans_tell_tilings_apart():
    """``unit_plan`` is equal for two compiles that launch the same
    kernels and differs where a tiling changes the units."""
    hw = get_config("cpu_test")
    c1 = _jit(_mm(), hw, use_disk=False, cache=CompilationCache(use_disk=False))
    same = api.compile_with_tilings(_mm(), hw, c1.record.tilings)
    assert unit_plan(same) == unit_plan(c1)
    assert unit_plan(api.compile_with_tilings(_mm(), hw, c1.record.tilings,
                                              backend="torch")) != unit_plan(c1)


def test_validate_top_k_records_into_the_db(tmp_path):
    db = TuningDB(dir=tmp_path)
    sweep = api.run_sweep(api.get_space("h100-sweep"), "mm_bias_gelu", budget=2,
                          measure_top_k=1, measure_device="cpu", tune_db=db)
    assert sweep.validation["device"] == "cpu"
    entries = list(db.entries().values())
    assert entries and all(e["interpret"] is True and e["backend"] == "cuda" for e in entries)
    assert {c["source"] for e in entries for c in e["candidates"].values()} == \
        {"explore.validate"}


def test_cli_measure_mode(tmp_path, capsys):
    from repro_torch.explore.__main__ import main

    out = tmp_path / "o"
    assert main(["--space", "h100-sweep", "--workloads", "mm_bias_gelu", "--budget", "1",
                 "--top-k", "0", "--measure", "2", "--device", "cpu", "--out", str(out),
                 "--tune-db", str(tmp_path / "db")]) == 0
    db = TuningDB(dir=tmp_path / "db")
    (e,) = db.entries().values()
    assert e["workload"] == "mm_bias_gelu" and e["interpret"] is True


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------
def test_fit_calibration_irls_recovers_scales_despite_outliers():
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(40):
        tm = float(rng.uniform(1e-5, 1e-3))
        tc = float(rng.uniform(1e-5, 1e-3))
        rows.append({"t_mem_raw": tm, "t_compute_raw": tc, "predicted_s": tm + tc,
                     "measured_s": 3.0 * tm + 5.0 * tc + 2e-6})
    for _ in range(5):  # gross outlier calls (GC pause, etc.)
        tm = float(rng.uniform(1e-5, 1e-3))
        tc = float(rng.uniform(1e-5, 1e-3))
        rows.append({"t_mem_raw": tm, "t_compute_raw": tc, "predicted_s": tm + tc,
                     "measured_s": 0.5})
    cal = fit_calibration(rows, "hwfp", "cuda")
    assert cal is not None and cal.method == "irls"
    assert cal.hw_fingerprint == "hwfp" and cal.backend == "cuda"
    assert cal.scale_mem == pytest.approx(3.0, rel=0.05)
    assert cal.scale_compute == pytest.approx(5.0, rel=0.05)
    assert 0.0 <= cal.overhead_s < 1e-4


def test_fit_calibration_gmean_fallback_without_terms():
    rows = [{"predicted_s": 1e-4, "measured_s": 4e-4} for _ in range(10)]
    cal = fit_calibration(rows, "hwfp", "cuda")
    assert cal is not None and cal.method == "gmean"
    assert cal.scale_mem == pytest.approx(4.0, rel=1e-6)
    assert cal.scale_compute == pytest.approx(4.0, rel=1e-6)
    assert fit_calibration([], "hwfp") is None


def test_calibration_applied_by_evaluate_tiling():
    hw = get_config("cpu_test")
    blk = _mm().entry.stmts[0]
    params = dict(dict(hw.passes)["autotile"])
    tiles = {"i": 8, "j": 8}
    base = evaluate_tiling(blk, tiles, hw, params)
    clear_calibrations()
    try:
        set_calibration(Calibration(hw_fingerprint=hw.fingerprint(), scale_mem=10.0,
                                    scale_compute=10.0, method="test"))
        cal = evaluate_tiling(blk, tiles, hw, params)
    finally:
        clear_calibrations()
    assert cal.calibrated and not base.calibrated
    assert cal.t_mem == pytest.approx(10 * base.t_mem)
    assert cal.t_compute == pytest.approx(10 * base.t_compute)
    assert cal.latency_s == pytest.approx(10 * base.latency_s)
    assert cal.t_mem_raw == base.t_mem_raw, "raw terms stay uncalibrated"


def test_calibration_rekeys_the_compile_cache(tmp_path):
    hw = get_config("cpu_test")
    cache = CompilationCache(disk_dir=tmp_path)
    c1 = _jit(_mm(), hw, cache=cache)
    clear_calibrations()
    try:
        set_calibration(Calibration(hw_fingerprint=hw.fingerprint(), scale_mem=2.0,
                                    scale_compute=2.0, method="test"))
        c2 = _jit(_mm(), hw, cache=cache)
    finally:
        clear_calibrations()
    assert c2.record.key != c1.record.key
    assert not c2.record.cache_hit, "calibrated compiles must never collide with uncalibrated ones"
    c3 = _jit(_mm(), hw, cache=cache)
    assert c3.record.cache_hit and c3.record.key == c1.record.key


def test_calibration_save_load_roundtrip(tmp_path):
    cal = Calibration(hw_fingerprint="hwfp", scale_mem=2.5, scale_compute=0.5,
                      overhead_s=1e-6, n_pairs=12, method="irls", backend="cuda")
    assert save_calibrations(tmp_path, cals=[cal]) is not None
    clear_calibrations()
    try:
        loaded = load_calibrations(tmp_path)
        assert len(loaded) == 1
        assert loaded[0].fingerprint() == cal.fingerprint()
        assert get_calibration("hwfp").scale_mem == 2.5
    finally:
        clear_calibrations()
    assert load_calibrations(tmp_path / "missing") == []


def test_calibration_fit_from_profiled_rows_reranks(tmp_path):
    """The loop phase 9 of chip_smoke.py closes on the card: profiled
    calls write residual rows, a fit over them activates for the config's
    fingerprint, and the cost model's predictions change with it."""
    hw = get_config("cpu_test")
    cache = CompilationCache(disk_dir=tmp_path)
    for w in api.get_workloads("quick"):
        c = _jit(w.build(), hw, cache=cache, profile=True)
        c(_random_arrays(c.program.source, device="cpu"))
    rows = read_residuals(t_profile.residual_log_path(cache))
    cal = fit_calibration(rows, hw.fingerprint(), "cuda")
    assert cal is not None and cal.n_pairs == len(rows)
    blk = _mm().entry.stmts[0]
    params = dict(dict(hw.passes)["autotile"])
    base = evaluate_tiling(blk, {"i": 8, "j": 8}, hw, params)
    clear_calibrations()
    try:
        set_calibration(cal)
        assert evaluate_tiling(blk, {"i": 8, "j": 8}, hw, params).latency_s != base.latency_s
    finally:
        clear_calibrations()


# --------------------------------------------------------------------------
# residual-log rotation (bounded growth)
# --------------------------------------------------------------------------
def test_residual_log_rotation_folds_into_db(tmp_path):
    path = tmp_path / "residuals.jsonl"
    rows = [{"backend": "torch", "hw_fingerprint": "h", "interpret": True,
             "predicted_s": 1e-4, "measured_s": 2e-4} for _ in range(10)]
    append_residuals(rows, path=path, cap=6)
    live = read_residuals(path)
    assert len(live) == 3, "rotation keeps the newest cap//2 rows"
    db = TuningDB(dir=tmp_path)
    folded = db.residual_summaries()
    assert sum(s["rows"] for s in folded) == 7
    summary = summarize_residuals(live, folded=folded)
    assert summary["rows"] == 10
    assert summary["live_rows"] == 3 and summary["folded_rows"] == 7
    assert summary["pairs_with_prediction"] == 10
    # the merged gmean covers the full history, not just the log tail
    assert summary["measured_over_predicted_gmean"] == pytest.approx(2.0)
    assert summary["by_backend"]["torch"] == 10
    # a second burst keeps folding additively
    append_residuals(rows, path=path, cap=6)
    assert sum(s["rows"] for s in TuningDB(dir=tmp_path).residual_summaries()) == 17


def test_residual_cap_disabled_keeps_everything(tmp_path):
    path = tmp_path / "residuals.jsonl"
    rows = [{"backend": "torch", "predicted_s": 1e-4, "measured_s": 2e-4} for _ in range(30)]
    append_residuals(rows, path=path, cap=0)
    assert len(read_residuals(path)) == 30
    assert not (tmp_path / "tuning_db.json").exists()


# --------------------------------------------------------------------------
# serving-engine opt-in (EngineConfig.tune)
# --------------------------------------------------------------------------
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
            head_dim=16, vocab_pad_multiple=16)


@pytest.fixture(scope="module")
def engine_model():
    jm = j_build(j_configs.get("llama3-8b").scaled(**TINY))
    params = api.params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                                 "cpu")
    return api.build_model(api.configs.get("llama3-8b").scaled(**TINY)), params


def _run_one(engine, params):
    engine.submit(api.Request(uid=0, prompt=np.arange(1, 5, dtype=np.int32),
                              sampling=api.SamplingParams(max_new_tokens=4)))
    return {r.uid: r.out_tokens for r in engine.run(params, max_steps=500)}


def test_engine_tune_consults_and_replays(tmp_path, engine_model):
    model, params = engine_model
    ec = api.EngineConfig(slots=2, max_len=32, page_size=8, device="cpu", tune=True)
    cache1 = CompilationCache(disk_dir=tmp_path)
    eng1 = api.ServingEngine(model, ec, compile_cache=cache1)
    out1 = _run_one(eng1, params)
    assert cache1.stats.tuned_misses > 0 and cache1.stats.tuned_hits == 0
    assert not [e for e in eng1.events() if e["event"] == "tuned_replay"]

    # feed the DB next to the cache from the engine's own compile records,
    # in the slot of the engine's device (the plain versions: interpret)
    db = TuningDB(dir=tmp_path)
    for name, rec in eng1.compile_records().items():
        assert rec.ir_fingerprint, name
        db.record(rec.ir_fingerprint, rec.hw_fingerprint, ec.backend, True,
                  tilings=rec.tilings, block_backends=rec.block_backends,
                  measured_s=1e-4, source="test", workload=name)
    assert len(db) > 0

    # a second engine (fresh cache instance = new process) replays tuned
    cache2 = CompilationCache(disk_dir=tmp_path)
    eng2 = api.ServingEngine(model, ec, compile_cache=cache2)
    out2 = _run_one(eng2, params)
    assert out2 == out1, "tuned replay must not change tokens"
    assert cache2.stats.tuned_hits > 0
    events = [e for e in eng2.events() if e["event"] == "tuned_replay"]
    assert events, "tuned bucket compiles must announce themselves"
    for e in events:
        assert e["candidate"] and e["source"] == "test"
        assert e["measured_s"] == 1e-4


def test_engine_tune_off_never_touches_the_db(tmp_path, engine_model):
    model, params = engine_model
    cache = CompilationCache(disk_dir=tmp_path)
    eng = api.ServingEngine(model, api.EngineConfig(slots=2, max_len=32, page_size=8,
                                                    device="cpu"), compile_cache=cache)
    _run_one(eng, params)
    assert cache.stats.tuned_hits == 0 and cache.stats.tuned_misses == 0
    assert not (tmp_path / "tuning_db.json").exists()


# --------------------------------------------------------------------------
# exact parity with the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hw", ["cpu_test", "tpu_v5e", "h100"])
def test_entry_key_and_candidate_id_equal_across_packages(hw):
    if hw == "h100":  # the port's own config: only the port compiles it
        _, rec = t_compile(_mm(), get_config(hw), cache=CompilationCache(use_disk=False),
                           use_disk=False)
        jrec = rec
    else:
        from repro.core.cache import CompilationCache as JCache

        _, rec = t_compile(_mm(), get_config(hw), cache=CompilationCache(use_disk=False),
                           use_disk=False)
        _, jrec = j_compile(j_single(MM[0], MM[1], out="O"), j_hw(hw),
                            cache=JCache(use_disk=False), use_disk=False)
        assert (rec.ir_fingerprint, rec.hw_fingerprint, rec.tilings) == \
            (jrec.ir_fingerprint, jrec.hw_fingerprint, jrec.tilings)
    for backend in ("cuda", "pallas"):
        for interpret in (True, False):
            assert entry_key(rec.ir_fingerprint, rec.hw_fingerprint, backend, interpret) == \
                j_entry_key(jrec.ir_fingerprint, jrec.hw_fingerprint, backend, interpret)
    bb = {"op0": "torch"}
    assert candidate_id(rec.tilings) == j_candidate_id(jrec.tilings)
    assert candidate_id(rec.tilings, bb) == j_candidate_id(jrec.tilings, bb)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_db_files_are_readable_across_packages(tmp_path, writer):
    W, R = (TuningDB, JTuningDB) if writer == "port" else (JTuningDB, TuningDB)
    w = W(dir=tmp_path)
    tilings = {"mm#abc": {"i": 8, "j": 8}}
    cid = w.record("ir", "hw", "cuda", False, tilings=tilings, measured_s=3e-6,
                   predicted_s=1e-6, block_backends={"mm": "cuda"}, rounds=3,
                   source="explore.measure", workload="mm")
    w.fold_residuals([{"hw_fingerprint": "hw", "backend": "cuda", "interpret": False,
                       "predicted_s": 1e-6, "measured_s": 3e-6}])
    r = R(dir=tmp_path)
    e = r.lookup("ir", "hw", "cuda", False)
    assert e is not None and e.candidate_id == cid and e.tilings == tilings
    assert e.block_backends == {"mm": "cuda"} and e.workload == "mm" and e.rounds == 3
    assert r.residual_summaries() == w.residual_summaries()
    assert r.entries() == w.entries()
    # and the reader's write keeps the other's entries
    r.record("ir", "hw", "cuda", False, tilings={"mm#abc": {"i": 4, "j": 8}},
             measured_s=1e-6, source="reader")
    assert W(dir=tmp_path).lookup("ir", "hw", "cuda", False).source == "reader"
    assert len(W(dir=tmp_path).entries()[entry_key("ir", "hw", "cuda", False)]
               ["candidates"]) == 2


def test_obs_cli_prints_what_the_reference_prints(tmp_path, capsys):
    # one trace file, written by the reference's tracer
    tr = j_trace.get_tracer()
    was = tr.enabled
    j_trace.enable()
    j_trace.clear()
    try:
        with j_trace.span("pass.fuse"):
            pass
        t0 = time.perf_counter()
        j_trace.span_at("serve.request", t0 - 0.5, t0, uid=0, status="ok", tokens=4)
        j_trace.span_at("serve.queue", t0 - 0.5, t0 - 0.4, uid=0)
        j_trace.span_at("serve.prefill", t0 - 0.4, t0 - 0.3, uid=0)
        trace_path = tmp_path / "t.json"
        tr.export_chrome_trace(str(trace_path))
    finally:
        j_trace.clear()
        if not was:
            j_trace.disable()
    # one residual log whose older rows folded into the DB beside it
    log = tmp_path / "residuals.jsonl"
    rows = [{"backend": "cuda", "hw_fingerprint": "h", "interpret": False,
             "predicted_s": 1e-4, "measured_s": 2e-4 * (1 + i % 3)} for i in range(10)]
    append_residuals(rows, path=log, cap=6)
    for argv in (["summarize", str(trace_path), "--requests"],
                 ["residuals", str(log)], ["residuals", str(log), "--json"],
                 ["residuals", str(tmp_path / "missing.jsonl")]):
        rc_ref = j_obs_cli(argv)
        out_ref = capsys.readouterr().out
        rc_port = t_obs_cli(argv)
        out_port = capsys.readouterr().out
        assert (rc_port, out_port) == (rc_ref, out_ref), argv
    assert "folded into the tuning DB" in out_ref or "0 residual rows" in out_ref
