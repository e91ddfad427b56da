"""What the benchmark may load and read: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``fenet`` (compared whole: ``fenet_torch``
is the program), a reference that imports nothing of the program, and no
read of the JAX package's benchmark scripts, records or test tree."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fenet"}
# Files of the repository that the benchmark never reads.
FORBIDDEN_FILES = re.compile(r"(^|/)(bench\.py|tpu_smoke\.py|chip_smoke\.py|BENCH_[^/]*\.json)$"
                             r"|^" + re.escape(str(ROOT)) + r"/tests/")


def _sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_and_the_counts_import_nothing_of_the_program():
    for folder in ("reference", "counts"):
        for path in (HERE / folder).glob("*.py"):
            assert "fenet_torch" not in set(_imports(path)), path


def test_no_source_names_the_jax_packages_benchmark_or_its_tests():
    pattern = re.compile(r"bench\.py|tpu_smoke|chip_smoke|BENCH_|(^|[\s\"'(])tests/")
    for path in _sources():
        assert not pattern.search(path.read_text()), path


_PROBE = r"""
import json, sys, time, pathlib, tempfile
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" and isinstance(args[0], str) else None)
sys.path.insert(0, {root!r})
import torch
from portbench import harness
from portbench.tests import tiny
with tempfile.TemporaryDirectory() as d:
    result, _ = tiny.run(pathlib.Path(d), "tiny_eval")
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "opened": opened, "correct": result["correct"],
                  "forbidden": harness.forbidden_modules()}}))
"""


def test_a_run_loads_no_jax_and_reads_no_forbidden_file():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["correct"] and "fenet_torch" in seen["modules"]
    assert not set(seen["modules"]) & FORBIDDEN and seen["forbidden"] == []
    bad = [p for p in seen["opened"] if FORBIDDEN_FILES.search(p)]
    assert bad == []
