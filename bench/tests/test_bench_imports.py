"""The check that nothing the benchmark runs loads JAX or the JAX package,
by top-level module names compared whole (``repro_torch`` is not
``repro``); the reference imports nothing of the program."""
import ast
import subprocess
import sys

import tiny_cell
from benchkit import imports


def test_forbidden_compares_whole_top_level_names():
    assert imports.forbidden(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert imports.forbidden(["repro.models", "jax.numpy", "jaxlib", "flax.linen",
                              "reprox"]) == ["flax", "jax", "jaxlib", "repro"]


def test_harness_process_loads_no_jax():
    code = (
        "import sys, runpy\n"
        f"sys.path[:0] = [{str(tiny_cell.BENCH)!r}, {str(tiny_cell.REPO / 'src')!r}]\n"
        "import benchkit.cell, benchkit.program, benchkit.reference, benchkit.correct\n"
        "import repro_torch.serving.server, repro_torch.serving.engine, repro_torch.models\n"
        "import repro_torch.kernels.ops, repro_torch.serving.trace, repro_torch.serving.metrics\n"
        "from benchkit import imports\n"
        "print(imports.forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((tiny_cell.BENCH / "benchkit" / "reference.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "math", "typing", "torch"}


def test_no_file_of_the_benchmark_reads_the_jax_benchmarks():
    for p in tiny_cell.BENCH.rglob("*.py"):
        if p.name.startswith("test_bench_imports"):
            continue
        text = p.read_text()
        assert "import jax" not in text and "from repro." not in text \
            and "import repro\n" not in text and "benchmarks/" not in text, p
