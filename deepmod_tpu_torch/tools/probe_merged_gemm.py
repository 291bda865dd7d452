"""Probe: the merged [x; h] gate product (K5a) against K1's two products.

    python -m deepmod_tpu_torch.tools.probe_merged_gemm [--device cuda] [--batch N]

Counterpart of ``scripts/probe_merged_gemm.py``. K1 runs two dot products
a step (x_t against Wx, then h against Wh, from two buffers); K5a
assembles [x_t; h] in shared memory and runs one over the stacked
[Wx; Wh], the same FLOPs at the cost of a copy a step and a larger
block. Both through ``bilstm_center_mono`` (``merged_gemm``), ending in
the argmax of the logits, in bf16 and fp32 at each tile of the sweep, in
the same process; prints windows/s. ``--device cpu`` times the plain
versions instead.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from deepmod_tpu_torch.tools import _mono_probe as common


def main(argv: Optional[Sequence[str]] = None) -> int:
    from deepmod_tpu_torch.ops import bilstm_fused as ops

    args = common.parse_args(
        "python -m deepmod_tpu_torch.tools.probe_merged_gemm",
        __doc__.split("\n\n")[0], argv)
    device, cfg, params, x = common.setup(args.device, args.batch)
    for precision in ("bf16", "fp32"):
        packed = ops.pack_bilstm_params(params, cfg, precision)
        xp = x.to(ops.seq_dtype(precision))
        for tile_b in common.TILES:
            row = [f"{precision} tile_b={tile_b}:"]
            for merged in (False, True):
                r = common.windows_per_s(
                    lambda: common.classify(ops.bilstm_center_mono(
                        packed, xp, cfg, precision, tile_b=tile_b,
                        merged_gemm=merged), params),
                    args.batch, device)
                row.append(f"{'merged' if merged else 'twodot'}="
                           f"{r / 1e6:.2f}M/s")
            print(" ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
