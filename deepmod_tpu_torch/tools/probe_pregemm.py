"""Probe: pre-projected gates (K5b) against K1's two products a step.

    python -m deepmod_tpu_torch.tools.probe_pregemm [--device cuda] [--batch N]

Counterpart of ``scripts/probe_pregemm.py``. K5b projects every step's
input of a layer first, into a gate buffer (device memory here, one
region a resident slot of a persistent grid in both precisions), and
leaves one h product a step to the recurrence; ``gate_store="bf16"``
halves that buffer's traffic and rounds the stored projections. Through
``bilstm_center_mono`` (``pregemm``, ``gate_store``), ending in the
argmax of the logits, at each tile of the sweep, in the same process,
with the script's variants: bf16 twodot / pre-f32 / pre-bf16, fp32
twodot / pre-f32; prints windows/s, one line a precision and tile. Each
variant runs at the tiles its kernel takes: in bf16 K1 and K5b, the
tensor-core kernels, at their one tile, 64, on one line. ``--device cpu`` times
the plain versions instead.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _mono_probe as common

# (precision, [(label, pregemm, gate_store)]), as the script's cases
VARIANTS = (
    ("bf16", (("twodot", False, "fp32"), ("pre-f32", True, "fp32"),
              ("pre-bf16", True, "bf16"))),
    ("fp32", (("twodot", False, "fp32"), ("pre-f32", True, "fp32"))),
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    args = common.parse_args(
        "python -m deepmod_tpu_torch.tools.probe_pregemm",
        __doc__.split("\n\n")[0], argv)
    device, cfg, params, x = common.setup(args.device, args.batch)
    for precision, variants in VARIANTS:
        packed = ops.pack_bilstm_params(params, cfg, precision)
        xp = x.to(ops.seq_dtype(precision))
        takes = {label: common.tiles("pregemm" if pregemm else "mono",
                                     precision)
                 for label, pregemm, _ in variants}
        for tile_b in sorted(set().union(*takes.values())):
            row = [f"{precision} tile_b={tile_b}:"]
            for label, pregemm, gate_store in variants:
                if tile_b not in takes[label]:
                    continue
                r = common.windows_per_s(
                    lambda: common.classify(ops.bilstm_center_mono(
                        packed, xp, cfg, precision, tile_b=tile_b,
                        pregemm=pregemm, gate_store=gate_store), params),
                    args.batch, device)
                row.append(f"{label}={r / 1e6:.2f}M/s")
            print(" ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
