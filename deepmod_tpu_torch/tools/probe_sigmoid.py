"""K1 fp32 with exp sigmoids against the same kernel with tanh-form
sigmoids.

    python -m deepmod_tpu_torch.tools.probe_sigmoid
        [--batches 65536 131072] [--iters 16]

Counterpart of ``scripts/probe_sigmoid.py``. K1 fp32 computes its gate
sigmoids as 1/(1+exp(-x)) (``csrc/lstm_f32.cuh``'s Infer policy, through
``lstm_common.cuh::cell<false>``); the tanh form 0.5*tanh(0.5*x)+0.5 (the
bf16 contract's, without the pre-halved weights) trades the exp and the
divide for one tanh. The tanh form is the same source built with
``-DDMT_TANH_SIGMOID`` (``ops/_build.py::variant_library``: K1's
``bilstm_fused.cu`` alone, into ``build/kernels_dmt_tanh_sigmoid/``); the
default build never sets it. For each batch of seeded full-width windows
both builds run K1 fp32 in turns (default, tanh, tanh, default), each
``--iters`` launches timed by CUDA events after a warm-up; the tool
measures speed and reports the largest |logit difference| and the argmax
flips of the tanh form against the default build. Prints a JSON line a
batch. The builds are CUDA code: the tool needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _probe


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepmod_tpu_torch.tools.probe_sigmoid",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[65536, 131072])
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    from deepmod_tpu_torch.models.tf_import import params_from_numpy
    from deepmod_tpu_torch.ops import _build
    from deepmod_tpu_torch.ops import bilstm_fused as ops
    from deepmod_tpu_torch.tools.probe_tile import timed_ms
    from deepmod_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    print(_probe.header(device), flush=True)
    init, config = _probe.seeded_model(7)
    params = params_from_numpy(init, device)
    packed = ops.pack_bilstm_params(params, config, "fp32")
    gen = torch.Generator().manual_seed(1)
    for batch in args.batches:
        x = torch.randn(batch, 21, 7, generator=gen).to(device)

        def logits():
            feats = ops.bilstm_center_mono(packed, x, config, "fp32")
            return feats @ params["out_w"] + params["out_b"]

        ms = {"exp": [], "tanh": []}
        out = {}
        for form in ("exp", "tanh", "tanh", "exp"):
            if form == "tanh":
                with _build.variant(_build.TANH_SIGMOID):
                    out[form] = logits()
                    ms[form].append(timed_ms(logits, device, args.iters))
            else:
                out[form] = logits()
                ms[form].append(timed_ms(logits, device, args.iters))
        best = {k: min(v) for k, v in ms.items()}
        print(json.dumps({
            "batch": batch, "exp_ms": best["exp"], "tanh_ms": best["tanh"],
            "exp_windows_per_s": batch / best["exp"] * 1e3,
            "tanh_windows_per_s": batch / best["tanh"] * 1e3,
            "tanh_over_exp": best["tanh"] / best["exp"],
            "max_abs_dlogit": float((out["tanh"] - out["exp"]).abs().max()),
            "argmax_flips": int((out["tanh"].argmax(1)
                                 != out["exp"].argmax(1)).sum()),
            "ms_in_turns": ms,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
