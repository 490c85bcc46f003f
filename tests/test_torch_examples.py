"""The four example twins (``examples/torch_*.py``) and the port's facade
against the JAX package's.

* Each twin runs with ``--device cpu`` (its kernels' plain versions) in a
  subprocess within a time limit, at a small size, and exits 0.
* ``torch_compile_op_with_stripe.py``'s Fig. 5 rewrite and its
  pass-by-pass trace under ``tpu_v5e`` print the text that
  ``examples/compile_op_with_stripe.py``'s functions print (both called
  in this process).
* Every name of ``repro.api.__all__`` has its counterpart in
  ``repro_torch.api.__all__`` (``lower_program_jnp``'s is
  ``lower_program_torch``), and each is the port's own object.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import api as j_api  # noqa: E402

from repro_torch import api as t_api  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWIN = {"lower_program_jnp": "lower_program_torch"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", [], "contraction kernel (cpu) matches numpy: OK"),
    ("torch_compile_op_with_stripe.py", [], "max |err| vs the reference interpreter"),
    ("torch_serve_batched.py", ["--requests", "3", "--new-tokens", "4"],
     "3/3 requests completed"),
    ("torch_train_tiny_lm.py", ["--steps", "3", "--seq", "16", "--batch", "2"],
     "final loss:"),
])
def test_twin_runs_on_the_cpu(tmp_path, script, args, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), STRIPE_CACHE_DIR=str(tmp_path / "c"))
    run = subprocess.run([sys.executable, str(EXAMPLES / script), "--device", "cpu", *args],
                         env=env, cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert expect in run.stdout
    assert "import jax" not in (EXAMPLES / script).read_text()


@pytest.mark.parametrize("part", ["fig5_rewrite", "pass_by_pass"])
def test_compile_op_twin_prints_the_reference_text(part):
    ref, twin = _load("compile_op_with_stripe"), _load("torch_compile_op_with_stripe")
    args = ("tpu_v5e",) if part == "pass_by_pass" else ()
    want = _printed(getattr(ref, part))
    got = _printed(getattr(twin, part), *args)
    assert got == want and len(want) > 500
    if part == "pass_by_pass":
        assert "H100 pipeline" in _printed(twin.pass_by_pass)


def test_facade_has_every_reference_name_as_the_ports_object():
    missing = [n for n in j_api.__all__ if TWIN.get(n, n) not in t_api.__all__]
    assert missing == []
    for name in j_api.__all__:
        obj = getattr(t_api, TWIN.get(name, name))
        assert obj is not getattr(j_api, name)
        home = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(
            obj, "__module__", None)
        if home is None:        # a registry: the port's own dict
            from repro_torch.core import hwconfig
            assert obj is hwconfig.REGISTRY and name == "HW_REGISTRY"
            continue
        assert home.split(".")[0] == "repro_torch", (name, home)
    from repro_torch.core import cache, cost, interp, lower_torch, passes, tiling, validate
    from repro_torch.core.passes import autotile
    assert t_api.lower_program_torch is lower_torch.lower_program_torch
    assert (t_api.split_block, t_api.choose_tiling) == (tiling.split_block, autotile.choose_tiling)
    assert (t_api.evaluate_tiling, t_api.score_pass_trace) == (cost.evaluate_tiling,
                                                               cost.score_pass_trace)
    assert (t_api.compile_program, t_api.get_pass) == (passes.compile_program, passes.get_pass)
    assert (t_api.execute_reference, t_api.validate_program) == (interp.execute_reference,
                                                                 validate.validate_program)
    assert (t_api.CompilationCache, t_api.get_default_cache, t_api.set_default_cache) == (
        cache.CompilationCache, cache.get_default_cache, cache.set_default_cache)
    assert set(t_api.HW_REGISTRY) >= set(j_api.HW_REGISTRY) | {"h100"}
