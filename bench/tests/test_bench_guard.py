"""The JAX package stays out of the benchmark: no file under bench/
imports jax, jaxlib, flax or the JAX package (``repro``), no file of the
reference imports the port (``repro_torch``), and a run loads none of
them.  Names are compared by their top-level part, whole: the port's
name begins with the JAX package's."""
import ast
import subprocess
import sys

import bench_tiny
from bench import guard

BENCH = bench_tiny.ROOT / "bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_top_level_names_compare_whole():
    assert guard.forbidden(["repro_torch.api", "repro_torch", "bench.harness"]) == []
    assert guard.forbidden(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_bench_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert guard.forbidden(_imports(f)) == [], f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert "repro_torch" not in tops and not guard.forbidden(tops), f


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench_tiny\n"
        "from bench import guard, harness\n"
        "for cell in bench_tiny.CELLS:\n"
        "    harness.run_cell(cell, 3, 0.3, cell.endswith('docs'), device='cpu',\n"
        "                     overrides=bench_tiny.overrides(cell))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'}))\n"
        "print('repro_torch' in sys.modules)\n"
    ) % (str(bench_tiny.ROOT / "bench" / "tests"), str(bench_tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(bench_tiny.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "chatglm3-6b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
