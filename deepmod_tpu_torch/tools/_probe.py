"""What the probe and loop tools share: device timing, a seeded model,
engine-shaped feature rows and the pod5 cohorts of the loop tools."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np


def header(device) -> str:
    """The device a tool runs on, the host's cores and the card's name
    and power limit (``_host_bench.machine_line``)."""
    from deepmod_tpu_torch.tools._host_bench import machine_line

    return f"[probe] device {device} | {machine_line()}"


def sync(device) -> None:
    """Wait for every queued launch on ``device`` (a no-op on the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device) -> Tuple[object, float]:
    """(fn's result, host-clock seconds), ``device`` synchronized before
    and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def seeded_model(fnum: int = 7, hidden: int = 100, seed: int = 0,
                 timesteps: int = 21):
    """(numpy params, BiLSTMConfig): a random full-width model from a
    numpy seed."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
    from deepmod_tpu_torch.models.tf_import import params_to_numpy

    config = BiLSTMConfig(num_input=fnum, num_hidden=hidden,
                          timesteps=timesteps)
    return params_to_numpy(init_bilstm_params(seed, config, device="cpu")), \
        config


def engine_rows(rng: np.random.RandomState, rows: int,
                fnum: int = 7) -> np.ndarray:
    """Engine-shaped (rows, fnum) features, the JAX probes' layout: (fnum
    57: 50 integer histogram counts < 40 first) a 0/1 one-hot or none,
    mean, stdv, length."""
    feats = np.zeros((rows, fnum), np.float32)
    hot = rng.randint(0, 5, rows)
    onehot0 = fnum - 7  # one-hot columns: 0..3 (fnum 7) / 50..53 (57)
    for b in range(4):
        feats[hot == b, onehot0 + b] = 1.0
    if fnum == 57:
        feats[:, :50] = rng.randint(0, 40, (rows, 50))
    feats[:, onehot0 + 4] = (rng.randn(rows) * 2).round(3)
    feats[:, onehot0 + 5] = np.abs(rng.randn(rows) * 2).round(3)
    feats[:, onehot0 + 6] = rng.randint(4, 40, rows)
    return feats


def write_cohort(out: str, num_reads: int, seed: int, shift: float,
                 genome: Dict[str, str], n_files: int = 1,
                 mod_motif: Optional[str] = "CG") -> str:
    """A pod5 + basecall BAM cohort under ``out`` on ``genome`` (a CG
    signal shift when ``shift``; every base dwells 8 samples, so the move
    table's base boundaries are the signal's); returns ``out``."""
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )

    write_move_dataset_pod5(out, SynthConfig(
        genome_sizes={}, num_reads=num_reads, seed=seed,
        fast5_style="move", samples_per_base=(8, 8),
        mod_motif=mod_motif if shift else None, mod_level_shift=shift),
        n_files=n_files, genome=genome)
    return out


def cohort_inputs(folder: str) -> list:
    """The CLI's input flags for a ``write_cohort`` folder."""
    return ["--wrkBase", os.path.join(folder, "pod5"), "--basecalls",
            os.path.join(folder, "calls.bam"), "--Ref",
            os.path.join(folder, "ref.fa"), "--alignStr", "builtin"]
