"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process:

    python3 bench_h100/calibrate.py --workload <name> --seeds 101-112 \
        --control-seeds 201-203

For every seed of ``--seeds`` the program's reading of each compared
number: a detect cell's ``check_batches`` batches through
``predict_batch_windows`` (the timed path), the same sample of their
reads as a run checks, against the reference; a train
cell's first ``checked_steps`` steps through the train step. For every
seed of ``--control-seeds`` the control's: the reference in the
configuration's ``control`` precision put in the program's place. On those
seeds also the faults a run's check must catch, planted in the answers or
in the reference put in the program's place: detect, half of each batch's
answers left out (zeros) and one checked answer altered; train,
half of each batch left out (the mean over the rest) and the state left
unchanged. One JSON line a seed and side; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_h100.jobs import detect, train  # noqa: E402
from bench_h100.registry import CHECKOUT, Registry  # noqa: E402
from bench_h100.run import HOST_THREADS  # noqa: E402
from bench_h100.seeds import rng  # noqa: E402
from bench_h100.window import free  # noqa: E402


def seed_list(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def detect_seed(cfg, traffic, seed, device, control: bool):
    setup = detect.Setup(cfg, traffic, seed, device)
    batches = [next(setup.batches) for _ in range(traffic["check_batches"])]
    kept = [(idx, setup.run_batch(idx)) for idx in batches]
    weights, pool = setup.weights, setup.pool
    del setup
    free(device)
    budget = traffic["check_windows"]
    idx, preds = detect.checked_reads(kept, pool, budget, seed)
    ref = detect.reference_logits(weights, pool, idx, cfg, "fp64", device)
    out = {"program": detect.logit_gap(preds, ref), "windows": len(preds)}
    if control:
        half = [(b, p.copy()) for b, p in kept]
        for _, p in half:
            p[len(p) // 2 :] = 0
        _, q = detect.checked_reads(half, pool, budget, seed)
        out["half_left_out"] = detect.logit_gap(q, ref)
        q = preds.copy()
        k = int(rng(seed, "fault").integers(0, len(q)))
        q[k] = 1 - q[k]
        out["one_altered"] = detect.logit_gap(q, ref)
        c = detect.reference_logits(weights, pool, idx, cfg, cfg["control"],
                                    device)
        out["control"] = detect.logit_gap(
            c.argmax(dim=1).cpu().numpy().astype(np.int8), ref)
    return out


def look(got, want):
    """Where a train number comes from: each step's loss gap and the worst
    leaf of each norm gap, with its gap."""
    grads = train.leaf_gaps(got["grad_norms"], want["grad_norms"])
    change = train.leaf_gaps(got["change_norms"], want["change_norms"],
                             train.moved_leaves(want["grad_norms"]))
    return {"loss_gaps": train.loss_gaps(got["losses"], want["losses"]),
            "worst_grad_leaf": max(grads, key=grads.get),
            "worst_grad_gap": max(grads.values()),
            "worst_change_leaf": max(change, key=change.get),
            "worst_change_gap": max(change.values()),
            "left_out": sorted(set(want["grad_norms"])
                               - set(train.moved_leaves(want["grad_norms"])))}


def train_seed(cfg, traffic, seed, device, control: bool):
    setup = train.Setup(cfg, traffic, seed, device)
    got = setup.first_steps(traffic["checked_steps"])
    rows = list(setup.rows)
    weights0, feed = setup.weights0, setup.feed
    del setup
    free(device)
    want = train.reference_steps(weights0, feed, rows, cfg, "fp64")
    out = {"program": train.compare(got, want), "look": look(got, want)}
    if control:
        ctl = train.reference_steps(weights0, feed, rows, cfg, cfg["control"])
        out["control"] = train.compare(ctl, want)
        out["control_look"] = look(ctl, want)
        half = feed.mask.clone()
        half[len(half) // 2 :] = 0
        out["half_left_out"] = train.compare(
            train.reference_steps(weights0, feed, rows, cfg, "fp64", half),
            want)
        still = dict(got, change_norms={k: 0.0 for k in got["change_norms"]})
        out["state_unchanged"] = train.compare(still, want)
    return out


def main(argv=None, root: str = CHECKOUT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    reg = Registry(root)
    cell = reg.cell(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    fn = detect_seed if traffic["kind"] == "detect" else train_seed
    torch.set_num_threads(HOST_THREADS)
    plan = [(s, False) for s in seed_list(args.seeds)] if args.seeds else []
    if args.control_seeds:
        plan += [(s, True) for s in seed_list(args.control_seeds)]
    for seed, control in plan:
        row = fn(cfg, traffic, seed, args.device, control)
        print(json.dumps({"workload": args.workload, "seed": seed, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
