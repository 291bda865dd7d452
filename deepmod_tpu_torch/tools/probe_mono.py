"""Probe: the whole-stack mono kernel (K1) against the layered kernel (K4).

    python -m deepmod_tpu_torch.tools.probe_mono [--device cuda] [--batch N]

Counterpart of ``scripts/probe_mono.py``: the same function, (B, 21, 7)
windows -> center features -> argmax of the logits, through the layered
kernel (``bilstm_center_features(..., mono=False)``, a launch a layer,
the inter-layer sequences in device memory) and through the mono kernel
(``bilstm_center_mono``, one launch), in bf16 and fp32 at each tile of
the sweep (in bf16 both are tensor-core kernels, at their one tile,
64); prints windows/s. ``--device cpu`` times the plain
versions instead.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _mono_probe as common


def main(argv: Optional[Sequence[str]] = None) -> int:
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    args = common.parse_args("python -m deepmod_tpu_torch.tools.probe_mono",
                             __doc__.split("\n\n")[0], argv)
    device, cfg, params, x = common.setup(args.device, args.batch)
    for precision in ("bf16", "fp32"):
        packed = ops.pack_bilstm_params(params, cfg, precision)
        xp = x.to(ops.seq_dtype(precision))
        kernels = (
            ("layered", lambda t: ops.bilstm_center_features(
                packed, xp, cfg, precision, tile_b=t, mono=False)),
            ("mono", lambda t: ops.bilstm_center_mono(
                packed, xp, cfg, precision, tile_b=t)),
        )
        for name, center in kernels:
            for tile_b in common.tiles(name, precision):
                r = common.windows_per_s(
                    lambda: common.classify(center(tile_b), params),
                    args.batch, device)
                print(f"{precision} {name:7} tile_b={tile_b}: "
                      f"{r / 1e6:.3f}M windows/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
