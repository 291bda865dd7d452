"""On the card: one short run of a detect cell and of the train cell
through the command the driver runs (``-m gpu``; skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CHECKOUT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["detect_f7_bf16_long", "train_f7_fp32_b2048"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=CHECKOUT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if name.endswith("_roofline") or "mfu" in name:
                assert 0 < m["value"] <= 105, (name, m)
