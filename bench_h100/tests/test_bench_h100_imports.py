"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``deepmod_tpu`` (whole names: ``deepmod_tpu_torch`` begins
with ``deepmod_tpu``), and a run that finds one, or no card, or no program
beside it, prints no result."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import types

from bench_h100 import run
from conftest import BENCH, CHECKOUT, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "deepmod_tpu"}


def test_no_source_of_the_harness_imports_them():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_a_run_loads_none_of_them(tmp_path):
    script = f"""
import json, sys
sys.path.insert(0, {CHECKOUT!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
from conftest import small_root
from bench_h100 import run
root = small_root({str(tmp_path)!r})
for cell in ("d_bf16", "t_fp32"):
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                     "--trace", "0"], root=root, device="cpu") == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "deepmod_tpu_torch" in loaded and "bench_h100" in loaded
    assert not loaded & FORBIDDEN


def test_a_loaded_jax_stops_the_result(root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run_cell(root, "d_fp32", seconds=0.2, capsys=capsys)
    assert rc == 3 and line is None
    monkeypatch.delitem(sys.modules, "jax")
    # the port's own name is not the JAX package's
    assert "deepmod_tpu_torch" in sys.modules and run.forbidden_modules() == []


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "detect_f7_bf16_long", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=CHECKOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under the
    benchmark's paths: the program is missing, so no result."""
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "detect_f7_bf16_long", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "deepmod_tpu_torch" in out.stderr
