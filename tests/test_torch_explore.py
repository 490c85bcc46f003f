"""The port's exploration path against the JAX package's.

* Every unit of the ``default`` corpus plus ``conv_mlp``, under
  ``tpu_v5e``, ``cpu_test`` and ``paper_fig4``, with and without the
  fusion pass: a unit the reference lowers to ``pallas`` lowers to
  ``cuda`` in the port (its contraction, elementwise or windowed kernel,
  here run as the plain version on CPU tensors), a unit the reference
  leaves on ``jnp`` stays on ``torch`` with the same reason, and the
  outputs agree with the reference's Pallas kernels in interpret mode
  (under ``paper_fig4``, whose 8-element cache-line tiles give grids that
  take Pallas interpret mode a minute per program here, with the
  reference's ``jnp`` backend instead):
  integers exactly; float32 within 1e-4 of the output's largest value
  (sums of up to 1024 float32 terms in two orders); bf16 within 1e-2 of
  the element plus 1e-3 of the largest value (both sides round the same
  float32 sums to bf16, whose spacing is 2**-8 = 3.9e-3 of the value, and
  the reference's Pallas prologue rounds bf16 operand DAGs once more).
* The cost-only sweep: fingerprints, dedupe, scores, the Pareto front and
  the report equal the reference's, apart from times.
* ``validate_top_k`` on the CPU (the kernels' plain versions), the
  ``h100-sweep`` space, the refusals of what is not ported, the facade,
  and ``_random_arrays`` drawing the reference's numbers.
"""
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as j_api  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.core.driver import stripe_jit as j_jit  # noqa: E402
from repro.core.hwconfig import get_config as j_hw  # noqa: E402
from repro.explore import build_report as j_report  # noqa: E402
from repro.explore import get_space as j_space  # noqa: E402
from repro.explore import run_sweep as j_sweep  # noqa: E402
from repro.explore import to_markdown as j_markdown  # noqa: E402
from repro.explore.runner import _random_arrays as j_random_arrays  # noqa: E402
from repro.explore.workloads import get_workloads as j_workloads  # noqa: E402

from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core.driver import stripe_jit as t_jit  # noqa: E402
from repro_torch.core.hwconfig import get_config as t_hw  # noqa: E402
from repro_torch.explore import build_report as t_report  # noqa: E402
from repro_torch.explore import get_space as t_space  # noqa: E402
from repro_torch.explore import run_sweep as t_sweep  # noqa: E402
from repro_torch.explore import to_markdown as t_markdown  # noqa: E402
from repro_torch.explore.runner import _random_arrays as t_random_arrays  # noqa: E402
from repro_torch.explore.workloads import get_workloads as t_workloads  # noqa: E402

CORPUS = tuple(w.name for w in j_workloads("default")) + ("conv_mlp",)
HWS = ("tpu_v5e", "cpu_test", "paper_fig4")
KIND = {"pallas": "cuda", "jnp": "torch"}


def _inputs(prog, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for n in prog.inputs:
        d = prog.buffers[n]
        if str(d.dtype).startswith("int"):
            out[n] = rng.randint(-8, 8, size=d.shape).astype(d.dtype)
        else:
            out[n] = rng.randn(*d.shape).astype(np.float32)
    return out


def _tensor(v: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(v)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def assert_close_to_reference(got, want, dtype: str):
    """The tolerances of the module docstring, by output type."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    scale = float(np.abs(w).max()) if w.size else 0.0
    if dtype.startswith("int"):
        np.testing.assert_array_equal(g, w)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-3 * max(1.0, scale))
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1.0, scale))


def _hw_pair(hw: str, fuse: bool):
    jh, th = j_hw(hw), t_hw(hw)
    if not fuse:
        jh, th = jh.without_pass("fuse"), th.without_pass("fuse")
    return jh, th


@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "no-fuse"])
@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("name", CORPUS)
def test_block_backends_and_outputs_match_reference(name, hw, fuse):
    jprog = {w.name: w for w in j_workloads("all")}[name].build()
    tprog = {w.name: w for w in t_workloads("all")}[name].build()
    jh, th = _hw_pair(hw, fuse)
    jc = j_jit(copy.deepcopy(jprog), jh, "pallas", interpret=True,
               cache=j_cache.CompilationCache(use_disk=False), use_disk=False)
    tc = t_jit(copy.deepcopy(tprog), th, "cuda",
               cache=t_cache.CompilationCache(use_disk=False), use_disk=False)
    jrec, trec = jc.record, tc.record
    assert trec.groups == jrec.groups
    assert trec.block_backends == {u: KIND[b] for u, b in jrec.block_backends.items()}
    assert trec.fallback_reasons() == jrec.fallback_reasons()
    assert trec.backend == KIND[jrec.backend]
    assert trec.n_kernels == jrec.n_kernels
    if hw == "paper_fig4":
        jc = j_jit(copy.deepcopy(jprog), jh, "jnp",
                   cache=j_cache.CompilationCache(use_disk=False), use_disk=False)
    arrays = _inputs(jprog, seed=11)
    want = jc({k: jnp.asarray(v, jprog.buffers[k].dtype) for k, v in arrays.items()})
    got = tc({k: _tensor(v, tprog.buffers[k].dtype) for k, v in arrays.items()})
    assert sorted(got) == sorted(tprog.outputs)
    for k in tprog.outputs:
        assert_close_to_reference(got[k], want[k], str(tprog.buffers[k].dtype))


# ------------------------------------------------------- cost-only sweep
def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in ("wall_time_s", "compile_time_s")}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def _markdown_without_wall(md: str) -> str:
    return "\n".join(line.split("; wall")[0] for line in md.splitlines())


@pytest.mark.parametrize("strategy", ["grid", "random"])
def test_cost_only_sweep_report_equals_reference(strategy, tmp_path):
    kw = dict(budget=8, strategy=strategy, seed=3, parallel=False)
    js = j_sweep(j_space("tpu-sweep"), "quick", cache_dir=str(tmp_path / "j"), **kw)
    ts = t_sweep(t_space("tpu-sweep"), "quick", cache_dir=str(tmp_path / "t"), **kw)
    assert [p.fingerprint for p in ts.points] == [p.fingerprint for p in js.points]
    assert [p.dedup_of for p in ts.points] == [p.dedup_of for p in js.points]
    jdoc, tdoc = _strip_times(j_report(js)), _strip_times(t_report(ts))
    assert json.dumps(tdoc, sort_keys=True, default=str) == \
        json.dumps(jdoc, sort_keys=True, default=str)
    assert _markdown_without_wall(t_markdown(ts)) == _markdown_without_wall(j_markdown(js))


# ----------------------------------------------------- measured validation
def test_validate_top_k_on_the_cpu_runs_every_unit_on_its_kernel(tmp_path):
    sweep = t_sweep(t_space("h100-sweep"), "quick", budget=4,
                    cache_dir=str(tmp_path / "cache"), measure_top_k=2,
                    measure_device="cpu")
    v = sweep.validation
    assert v["backend"] == "cuda" and v["device"] == "cpu"
    assert len(v["entries"]) == 3  # the baseline and the top 2
    for e in v["entries"]:
        assert e["error"] == ""
        assert e["measured_total_us"] > 0
        assert set(e["measured_us"]) == {"mm_bias_gelu", "fig4_conv"}
        for wl, backends in e["block_backends"].items():
            assert backends and set(backends.values()) == {"cuda"}, (wl, backends)
    assert sorted(v["predicted_rank"]) == sorted(v["measured_rank"])
    assert v["estimator"] == "min-of-interleaved-rounds"


def test_h100_sweep_mirrors_tpu_sweep():
    tpu, h100 = t_space("tpu-sweep"), t_space("h100-sweep")
    assert h100.base == "h100"
    rename = {"mem.VMEM.size_bytes": "mem.SMEM.size_bytes"}
    assert [rename.get(a.path, a.path) for a in tpu.axes] == [a.path for a in h100.axes]
    assert [len(a.values) for a in tpu.axes] == [len(a.values) for a in h100.axes]
    base = t_hw("h100")
    stock = h100.apply(h100.default_point())
    assert stock.fingerprint() == base.fingerprint()
    assert h100.point_name(h100.default_point()) == "h100"
    for a in h100.axes:
        assert a.default in a.values
    # the pipeline axis keeps the elementwise units apart
    nofuse = h100.apply(dict(h100.default_point(), pipeline="no-fuse"))
    assert "fuse" not in [p for p, _ in nofuse.passes]


def test_what_is_not_ported_refuses_clearly(tmp_path):
    from repro_torch.explore.__main__ import main

    with pytest.raises(NotImplementedError, match="A9"):
        t_space("mesh-sweep")
    with pytest.raises(SystemExit) as exc:
        main(["--space", "mesh-sweep", "--out", str(tmp_path / "o")])
    assert exc.value.code != 0


def test_cli_cost_only_sweep(tmp_path):
    from repro_torch.explore.__main__ import main

    out = tmp_path / "cli_out"
    rc = main(["--space", "h100-sweep", "--workloads", "quick", "--budget", "3",
               "--top-k", "0", "--out", str(out)])
    assert rc == 0
    doc = json.loads((out / "explore_report.json").read_text())
    assert doc["space"] == "h100-sweep" and doc["n_points"] == 3 and doc["n_errors"] == 0
    assert (out / "explore_report.md").exists()
    assert (out / "cache").is_dir() and any((out / "cache").iterdir())


@pytest.mark.parametrize("name", ["explore", "get_workloads", "run_sweep", "get_space",
                                  "pareto_front", "dominating_baseline",
                                  "roofline_hillclimb"])
def test_facade_exports_exploration(name):
    assert name in t_api.__all__ and name in j_api.__all__
    assert getattr(t_api, name) is not None


def test_roofline_hillclimb_rows_equal_reference():
    from repro.explore.hillclimb import roofline_hillclimb as j_climb
    from repro_torch.explore.hillclimb import roofline_hillclimb as t_climb

    rows = {}
    for key, climb in (("j", j_climb), ("t", t_climb)):
        rows[key] = []
        climb(emit=lambda n, us, d, r=rows[key]: r.append((n, round(us, 6), str(d))))
    assert rows["t"] == rows["j"]


@pytest.mark.parametrize("name", CORPUS)
def test_random_arrays_draw_the_reference_numbers(name):
    prog = {w.name: w for w in t_workloads("all")}[name].build()
    want = j_random_arrays({w.name: w for w in j_workloads("all")}[name].build(), seed=5)
    got = t_random_arrays(prog, seed=5, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).endswith(str(prog.buffers[k].dtype))
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
