"""Probe: the merged [x; h] gate product (K5a) against K1's two products.

    python -m deepmod_tpu_torch.tools.probe_merged_gemm [--device cuda] [--batch N]

Counterpart of ``scripts/probe_merged_gemm.py``. K1 runs two dot products
a step (x_t against Wx, then h against Wh, from two buffers); K5a runs
one over the stacked [Wx; Wh]: in fp32 on the fp32 core's CUDA cores
over an operand ring whose slot stacks x_t on h (K1 fp32: the same fmaf
chains over two rings, so the same bits), in bf16 as one wgmma chain on
the tensor cores (K1 bf16: two wgmma chains a step). Both through
``bilstm_center_mono`` (``merged_gemm``), ending in the argmax of the
logits, in bf16 and fp32 at each tile of the sweep (in bf16 both are
tensor-core kernels, at their one tile, 64), in the same process; prints
windows/s. ``--device cpu`` times the plain versions instead.
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
        for merged in (False, True):
            schedule = "merged" if merged else "mono"
            for tile_b in common.tiles(schedule, precision):
                r = common.windows_per_s(
                    lambda: common.classify(ops.bilstm_center_mono(
                        packed, xp, cfg, precision, tile_b=tile_b,
                        merged_gemm=merged), params),
                    args.batch, device)
                print(f"{precision} {'merged' if merged else 'twodot'} "
                      f"tile_b={tile_b}: {r / 1e6:.2f}M/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
