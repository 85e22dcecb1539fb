"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: `airmodes_torch` begins with `airmodes`), and the
reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import ROOT
from benchmark import run

REFERENCE = ("reference.py", "modes.py", "judge.py", "traffic.py",
             "tracing.py", "spec.py", "gen.py", "frozen", "metrics")


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(out.split())


def test_reference_side_imports_neither_jax_nor_either_package():
    mods = _modules_after(
        "import benchmark.reference, benchmark.modes, benchmark.judge, "
        "benchmark.traffic, benchmark.tracing, benchmark.spec, benchmark.run")
    assert not mods & {"jax", "jaxlib", "flax", "airmodes",
                       "airmodes_torch"}


def test_sources_of_the_reference_name_no_package_of_the_program():
    names = []
    for item in REFERENCE:
        path = os.path.join(ROOT, "benchmark", item)
        files = [path] if item.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(path)
            for f in fs if f.endswith(".py")]
        for f in files:
            for node in ast.walk(ast.parse(open(f).read())):
                if isinstance(node, ast.Import):
                    names += [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "airmodes",
                       "airmodes_torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "airmodes_torch_x", sys)
    monkeypatch.delitem(sys.modules, "airmodes", raising=False)
    assert "airmodes" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "airmodes.dsp", sys)
    assert run.forbidden_modules() == ["airmodes"]


def test_a_folder_with_only_the_benchmark_gives_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone (no
    program): the run exits with another code than 0 and prints nothing
    on its standard output."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "int8_2msps.replay_1ch", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""
