"""Probe: K6's output bits from several checkouts of the port, compared.

    python -m deepmod_tpu_torch.tools.k6_bits --tree DIR [--tree DIR ...]
        [--device cuda] [--batch N]

Each tree's own ``deepmod_tpu_torch`` runs ``ops.lstm_layer.
lstm_recurrence`` (K6 on the card, its kernels built under that tree's
``build/``; the plain version with ``--device cpu``) in a child process
started in that tree, on the same numpy-seeded inputs: hidden 100 and
128, T=21, both directions, ``--batch`` windows of (B, T, 4H) gate
pre-activations and an (H, 4H) recurrent kernel. Prints one line a case
and tree: the output's sha256 (first 16 hex digits) and, for every tree
after the first, whether it holds the first tree's bits and the max abs
difference. To hold the checkout against an earlier commit, unpack that
commit (``git archive``) into an ignored directory and name both trees.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

BATCH = 262144
HIDDEN = (100, 128)
TIMESTEPS = 21

# what a child runs in its tree: argv = out path, device, batch
_CHILD = """
import sys
import numpy as np
import torch
from deepmod_tpu_torch.ops import lstm_layer as k6

out, device, batch = sys.argv[1], sys.argv[2], int(sys.argv[3])
got = {}
for hidden in %r:
    rng = np.random.default_rng(hidden)
    lim = np.sqrt(6.0 / (7 + 5 * hidden))
    w_h = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden))
                           .astype(np.float32)).to(device)
    xp = torch.from_numpy(rng.standard_normal(
        (batch, %d, 4 * hidden), dtype=np.float32)).to(device)
    for reverse in (False, True):
        key = "h%%d_%%s" %% (hidden, "bw" if reverse else "fw")
        got[key] = k6.lstm_recurrence(xp, w_h, 1.0, reverse).cpu().numpy()
np.savez(out, **got)
""" % (HIDDEN, TIMESTEPS)


def run_tree(tree: str, device: str, batch: int, out: str) -> None:
    """K6's outputs of ``tree``'s package into ``out`` (.npz)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("DMT_TORCH_BUILD_DIR", None)  # each tree builds under its own
    subprocess.run([sys.executable, "-c", _CHILD, out, device, str(batch)],
                   cwd=tree, env=env, check=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout's root (repeat; the first is the "
                         "reference)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="dmt_k6_bits_") as tmp:
        outs = []
        for i, tree in enumerate(args.tree):
            out = os.path.join(tmp, f"{i}.npz")
            run_tree(os.path.abspath(tree), args.device, args.batch, out)
            with np.load(out) as f:
                outs.append({k: f[k] for k in f.files})
    for key in outs[0]:
        ref = outs[0][key]
        for tree, got in zip(args.tree, outs):
            digest = hashlib.sha256(got[key].tobytes()).hexdigest()[:16]
            line = f"k6 {key} B={args.batch} {tree}: sha256 {digest}"
            if got is not outs[0]:
                same = bool(np.array_equal(got[key], ref))
                diff = float(np.abs(got[key] - ref).max())
                line += f", the first tree's bits: {same}, max abs {diff:.3e}"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
