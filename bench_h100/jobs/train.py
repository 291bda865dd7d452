"""The training step: ``train/trainer.py::make_train_step`` (the loss
forward through K2, the gradients through K3, Adam in place) at the
configuration's precision, over batches staged on the device.

Set-up makes the weights from the seed, builds the step and its Adam
state once, and drives that same object through its first
``checked_steps`` steps with the window's own call and feed (rows that all
differ); it records each step's loss, the first gradient as Adam got it
(its first moment after one step over 1 - b1) and the weights after the
last of them. The window then goes on from there. Once it has closed, the
reference takes the same steps from the same weights and rows, and the
checks are the gaps between the two sides' losses and per-leaf norms.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from bench_h100 import reference, traffic as gen
from bench_h100.jobs.detect import model_config
from bench_h100.weights import as_port_params, from_port_params, make_weights
from bench_h100.window import (Measurement, free, load_kernels, measure,
                               memory_peak, reset_peak)

B1 = 0.9  # Adam's first-moment decay, the port's and the reference's


class Setup:
    """The step object (model, Adam state, step function) and its feed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

        load_kernels(device)
        self.cfg, self.traffic, self.device = cfg, traffic, device
        train = cfg["train"]
        self.weights0 = make_weights(cfg, seed, device)
        self.params = as_port_params(
            {k: v.clone() for k, v in self.weights0.items()})
        self.opt = adam_init(self.params)
        self.step_fn = make_train_step(
            model_config(cfg), unbalanced=train["unbalanced"],
            precision=cfg["precision"], learning_rate=train["learning_rate"])
        self.feed = gen.TrainFeed(traffic, cfg, seed, device)
        reset_peak(device)
        self.order = self.feed.order()
        self.batch = traffic["batch"]
        self.rows: List[int] = []   # staged batch of each step so far

    def step(self) -> torch.Tensor:
        k = next(self.order)
        self.rows.append(k)
        return self.step_fn(self.params, self.opt, self.feed.x[k],
                            self.feed.y, self.feed.mask)

    def first_steps(self, count: int) -> Dict:
        """``count`` steps; what the check compares of them."""
        losses, grads = [], None
        for _ in range(count):
            losses.append(float(self.step()))
            if grads is None:
                mu = from_port_params(self.opt["mu"])
                grads = reference.norms({k: v / (1 - B1) for k, v in mu.items()})
        now = from_port_params(self.params)
        change = reference.norms({k: now[k].double() - self.weights0[k].double()
                                  for k in now})
        return {"losses": losses, "grad_norms": grads, "change_norms": change}


def loss_gaps(got: List[float], want: List[float]) -> List[float]:
    """Each step's relative gap of the loss."""
    if len(got) != len(want):
        return [float("inf")]
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves=None) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger; over
    ``leaves`` only where given."""
    names = list(want) if leaves is None else list(leaves)
    med = reference.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in names}


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's. The others (a key's bias under a
    softmax, say) move under Adam by round-off alone."""
    med = reference.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= 1e-3 * med]


def reference_steps(weights0: Dict[str, torch.Tensor], feed: gen.TrainFeed,
                    rows: List[int], cfg: Dict, mode: str,
                    mask=None) -> Dict:
    """What ``first_steps`` records, from the reference in ``mode`` (over
    the rows ``mask`` keeps, where given)."""
    mask = feed.mask if mask is None else mask
    batches = [(feed.x[k], feed.y, mask) for k in rows]
    out = reference.train(weights0, batches, cfg,
                          cfg["train"]["learning_rate"], mode)
    change = {k: out["params"][k].double() - weights0[k].double()
              for k in weights0}
    return {"losses": out["losses"],
            "grad_norms": reference.norms(out["first_grads"]),
            "change_norms": reference.norms(change)}


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The three numbers the check compares: the first step's loss (a
    later step's loss follows Adam's first update, which turns gradient
    round-off near eps into whole steps of some elements), and the median
    leaf's gap of the first gradient's norm and of the change's norm over
    the checked steps. Not the worst leaf's: on some seeds a bias's
    gradient is a sum that all but cancels, and its fp32 round-off reads
    up to 8e-5 of the median leaf's norm (PERF.md)."""
    return {
        "loss_gap": loss_gaps(got["losses"], want["losses"])[0],
        "median_leaf_grad_gap": reference.median(leaf_gaps(
            got["grad_norms"], want["grad_norms"]).values()),
        "median_leaf_change_gap": reference.median(leaf_gaps(
            got["change_norms"], want["change_norms"],
            moved_leaves(want["grad_norms"])).values()),
    }


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device, trace_path: str) -> Tuple[Measurement, Dict, int]:
    """Set up, measure, check: (measurement, checks, failed steps)."""
    setup = Setup(cfg, traffic, seed, device)
    checked = traffic["checked_steps"]
    got = setup.first_steps(checked)
    rows = list(setup.rows)
    m = Measurement("train", cfg, traffic)
    losses: List[torch.Tensor] = []

    def one() -> int:
        losses.append(setup.step())
        return setup.batch

    measure(m, one, seconds, trace, device, "train_step", trace_path)
    # a step whose loss is not finite failed
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = memory_peak(device)
    weights0, feed = setup.weights0, setup.feed
    del setup
    free(device)
    began = time.perf_counter()
    numbers = compare(got, reference_steps(weights0, feed, rows, cfg, "fp64"))
    m.counters["reference_s"] = time.perf_counter() - began
    limits = cfg["limits"]["train"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    m.counters["memory_peak_bytes"] = peak
    return m, checks, failed
