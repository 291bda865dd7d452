"""The harness's own tests: the checkout on ``sys.path`` (``bench_h100`` and
the program beside it), and a small benchmark root the CPU can run."""

import json
import os
import shutil
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

BENCH = os.path.join(CHECKOUT, "bench_h100")

# the cells' own traffic, cut to what a test run can hold (widths as
# published: the real configuration files and their limits)
SMALL_READS = {"pool_reads": 16, "reads_per_batch": 8,
               "events": {"dist": "lognormal", "median": 150, "sigma": 0.35,
                          "min": 60, "max": 600}}
SMALL_TRAIN = {"batch": 64, "staged_batches": 6}
# enough windows (about 19,000 checked) for TF32's flips to show
WIDE_READS = dict(SMALL_READS, events=dict(SMALL_READS["events"], median=1200,
                                           max=3000))


def small_root(tmp, extra_cells=()):
    """A benchmark root under ``tmp``: ``BENCHMARK.json`` with the small
    cells ``d_bf16``, ``d_fp32``, ``d_fp32_wide`` (detect) and ``t_fp32``
    (train) on the real configurations, metric readers and a copy of the
    real traffic files, plus the small traffic files ``small_reads``,
    ``wide_reads`` and ``small_train``."""
    root = os.path.join(str(tmp), "root")
    pkg = os.path.join(root, "bench_h100")
    for folder in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, folder), os.path.join(pkg, folder))
    with open(os.path.join(BENCH, "traffic", "long_reads.json")) as fh:
        reads = json.load(fh)
    reads.update(SMALL_READS)
    with open(os.path.join(pkg, "traffic", "small_reads.json"), "w") as fh:
        json.dump(reads, fh)
    reads.update(WIDE_READS)
    with open(os.path.join(pkg, "traffic", "wide_reads.json"), "w") as fh:
        json.dump(reads, fh)
    with open(os.path.join(BENCH, "traffic", "train_b2048.json")) as fh:
        train = json.load(fh)
    train.update(SMALL_TRAIN)
    with open(os.path.join(pkg, "traffic", "small_train.json"), "w") as fh:
        json.dump(train, fh)
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec_cells = spec["workloads"]
    kinds = {w["traffic"]: _traffic_kind(w["traffic"]) for w in spec_cells}
    cells = [("d_bf16", "deepmod_f7_bf16", "small_reads", "detect"),
             ("d_fp32", "deepmod_f7_fp32", "small_reads", "detect"),
             ("d_fp32_wide", "deepmod_f7_fp32", "wide_reads", "detect"),
             ("t_fp32", "deepmod_f7_fp32", "small_train", "train")]
    cells += list(extra_cells)
    spec["workloads"] = [dict(name=n, config=c, traffic=t, chips=1, why="test")
                         for n, c, t, _ in cells]
    # each metric goes to the small cells of the kind and configuration of
    # the real cells it lists
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            real = [w for w in spec_cells if w["name"] in metric["workloads"]]
            metric["workloads"] = [
                n for n, c, _, k in cells
                if any(k == kinds[w["traffic"]] and c == w["config"]
                       for w in real)]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh, indent=1)
    return root


def _traffic_kind(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        return json.load(fh)["kind"]


@pytest.fixture
def root(tmp_path):
    return small_root(tmp_path)


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def run_cell(root, cell, seed=12345, seconds=1.0, trace=0, capsys=None):
    """(exit code, result line or None) of a CPU run of ``cell``."""
    from bench_h100 import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu")
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out and out[-1].startswith("{") else None
    return rc, line
