"""Same-process A/B of the train step with fp32 and bf16 sequence storage
(K2 forward, K3 backward).

    python -m deepmod_tpu_torch.tools.probe_train_bf16 [--iters 20]
        [--batches 2048 65536] [--device cuda]

Counterpart of ``scripts/probe_train_bf16.py``. ``--trainPrecision bf16``
stores the training kernels' residual and gradient sequences in bfloat16
with fp32 weights, compute and weight gradients (the port's K2 runs the
fp32 core in both storage precisions; K3 stores its sequences in the
storage dtype). For each batch both steps (``train.trainer.
make_train_step``, Adam at 1e-3, from the same seeded full-width params
and one seeded batch) run a warm-up step, then ``max(4, iters * 2048 /
batch)`` steps timed by the host clock around a synchronized run. Prints a
JSON line a precision and batch (steps and windows a second, the loss
after the run) and one a batch with the bf16/fp32 rate and the loss
difference.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _probe


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_train_bf16",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=[2048, 65536])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

    print(_probe.header(args.device), flush=True)
    init, config = _probe.seeded_model(7)
    steps = {prec: make_train_step(config, False, prec)
             for prec in ("fp32", "bf16")}
    gen = torch.Generator().manual_seed(1)
    for batch in args.batches:
        x = torch.randn(batch, 21, 7, generator=gen).to(args.device)
        labels = torch.bernoulli(torch.full((batch,), 0.5), generator=gen)
        y = torch.nn.functional.one_hot(labels.long(), 2).float().to(
            args.device)
        mask = torch.ones(batch, device=args.device)
        rates, losses = {}, {}
        for prec in ("fp32", "bf16"):
            params = params_from_numpy(init, args.device)
            opt_state = adam_init(params)
            step = steps[prec]
            print(f"probe: warm-up {prec} b{batch}", file=sys.stderr,
                  flush=True)
            _probe.wall(lambda: step(params, opt_state, x, y, mask),
                        args.device)
            iters = max(4, args.iters * 2048 // batch)

            def run():
                loss = None
                for _ in range(iters):
                    loss = step(params, opt_state, x, y, mask)
                return float(loss)

            losses[prec], dt = _probe.wall(run, args.device)
            rates[prec] = iters / dt
            print(json.dumps({
                "precision": prec, "batch": batch,
                "steps_per_s": rates[prec],
                "windows_per_s": rates[prec] * batch,
                "loss_after": losses[prec], "device": args.device,
            }), flush=True)
        print(json.dumps({
            "metric": "train_bf16_speedup", "batch": batch,
            "value": rates["bf16"] / rates["fp32"],
            "loss_delta": abs(losses["bf16"] - losses["fp32"]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
