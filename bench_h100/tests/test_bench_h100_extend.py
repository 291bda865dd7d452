"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries only: the harness finds them by name, and no file that
was there changes."""

import hashlib
import json
import os

from bench_h100.registry import Registry
from conftest import run_cell

METRIC = '''"""windows_per_batch (windows/batch, program counter): windows asked for
a batch of the window."""


def read(m):
    if m.kind != "detect" or not m.iters:
        return None
    return m.work / m.iters
'''


def digests(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_and_entries_make_a_new_cell(root, capsys):
    pkg = os.path.join(root, "bench_h100")
    before = digests(pkg)
    with open(os.path.join(pkg, "configs", "deepmod_f7_fp32.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="deepmod_f7_fp32_h64", num_hidden=64, reduced=["num_hidden"])
    with open(os.path.join(pkg, "configs", "deepmod_f7_fp32_h64.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pkg, "traffic", "small_reads.json")) as fh:
        mix = json.load(fh)
    mix.update(reads_per_batch=4, events=dict(mix["events"], median=90))
    with open(os.path.join(pkg, "traffic", "short_reads.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(pkg, "metrics", "windows_per_batch.py"), "w") as fh:
        fh.write(METRIC)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    spec["configs"].append(dict(spec["configs"][1], name="deepmod_f7_fp32_h64",
                                file="bench_h100/configs/deepmod_f7_fp32_h64.json",
                                reduced=["num_hidden"]))
    spec["workloads"].append(dict(name="d_new", config="deepmod_f7_fp32_h64",
                                  traffic="short_reads", chips=1, why="new"))
    for m in spec["end_to_end"]:
        if m["name"] == "detect_windows_per_s.fp32":
            m["workloads"].append("d_new")
    spec["per_layer"].append(dict(
        name="windows_per_batch", unit="windows/batch", better="higher",
        source="program_counter", layer="engine device stage",
        moves="detect_windows_per_s.fp32", workloads=["d_new"]))
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)

    reg = Registry(root)
    assert reg.config("deepmod_f7_fp32_h64")["num_hidden"] == 64
    assert reg.traffic("short_reads")["reads_per_batch"] == 4
    assert [m["name"] for m in reg.metrics("d_new", True)][-1] == "windows_per_batch"
    rc, line = run_cell(root, "d_new", trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    per_batch = line["metrics"]["windows_per_batch"]
    assert per_batch["unit"] == "windows/batch" and per_batch["value"] > 0
    rc, line = run_cell(root, "d_new", trace=0, capsys=capsys)
    assert set(line["metrics"]) == {"detect_windows_per_s.fp32", "setup_s"}
    after = digests(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
