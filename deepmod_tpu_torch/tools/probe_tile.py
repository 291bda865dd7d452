"""K1's tile sweep, and the train step's rate.

    python -m deepmod_tpu_torch.tools.probe_tile [--batch 65536]
        [--tiles 8,16,24,32,40,48,64,80] [--device cuda]

Counterpart of ``scripts/probe_tile.py``, over the tiles the port's K1
takes: fp32 K1 (the fp32 core, ``ops.bilstm_fused.f32_shape``) takes any
multiple of 8 that fits a cluster's threads and shared memory (the
default picks the largest up to ``TILE_B`` = 40); bf16 K1 (the
tensor-core kernel) takes 64 windows a block only, so its row is the one
tile. The JAX probe swept its layered Pallas kernel over 128/256/512; a
tile no launch takes prints its error instead of a time. Each tile: K1's
center features, projection and argmax over ``--batch`` seeded full-width
windows, 16 calls timed by CUDA events after a warm-up (the host clock on
the CPU, where the plain version runs whatever the tile). Then the train
step (``train.trainer.make_train_step``, class-weighted, Adam, K2/K3) at
batch 2048: 32 steps after a warm-up. Prints a JSON line a (precision,
tile) and one for the train step.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _probe

ITERS = 16


def timed_ms(fn, device, iters: int = ITERS) -> float:
    """Milliseconds a call of ``fn`` over ``iters`` calls after one
    warm-up: CUDA events on a card, the host clock elsewhere."""
    import torch

    fn()
    if torch.device(device).type != "cuda":
        _, dt = _probe.wall(lambda: [fn() for _ in range(iters)], device)
        return 1e3 * dt / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_tile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--tiles", default="8,16,24,32,40,48,64,80",
                    help="fp32 K1 tiles (multiples of 8)")
    ap.add_argument("--train-batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.train.trainer import adam_init, make_train_step

    print(_probe.header(args.device), flush=True)
    init, config = _probe.seeded_model(7)
    params = params_from_numpy(init, args.device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(args.batch, 21, 7, generator=gen).to(args.device)
    sweep = [("fp32", int(t)) for t in args.tiles.split(",")]
    sweep.append(("bf16", ops.TC_TILE_B))
    for precision, tile in sweep:
        packed = ops.pack_bilstm_params(params, config, precision)

        def predict():
            feats = ops.bilstm_center_features(packed, x, config, precision,
                                               tile_b=tile)
            return torch.argmax(feats @ params["out_w"] + params["out_b"],
                                dim=-1)

        row = {"precision": precision, "tile_b": tile, "batch": args.batch,
               "device": args.device}
        try:
            if precision == "fp32":
                shape = ops.f32_shape(config.num_input, config.num_hidden,
                                      tile)
                row.update(split=shape.split, threads=shape.threads,
                           smem=shape.smem)
            ms = timed_ms(predict, args.device)
            row.update(ms=ms, windows_per_s=args.batch / ms * 1e3)
        except (ValueError, RuntimeError) as exc:
            row["error"] = f"{type(exc).__name__}: {exc}"
        print(json.dumps(row), flush=True)

    bt = args.train_batch
    xt = torch.randn(bt, 21, 7, generator=gen).to(args.device)
    labels = torch.bernoulli(torch.full((bt,), 0.5), generator=gen)
    yt = torch.nn.functional.one_hot(labels.long(), 2).float().to(args.device)
    mask = torch.ones(bt, device=args.device)
    opt_state = adam_init(params)
    step = make_train_step(config, True)
    step(params, opt_state, xt, yt, mask)
    _, dt = _probe.wall(lambda: [step(params, opt_state, xt, yt, mask)
                                 for _ in range(32)], args.device)
    print(json.dumps({"train_steps_per_s": 32 / dt, "batch": bt,
                      "device": args.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
