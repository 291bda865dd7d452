"""Training-data loading: feature files -> window batches.

Replicates the reference loader semantics (myMultiBiRNN.py:233-377):

- recursive ``*.xy.gz`` globbing up to 4 levels (getTFiles1, :234-240);
- read-based (``P,frac``) and region-based (``E,startMb,endMb``) holdout
  splits (DeepMod.py:212-222 + :244-247, 326-329);
- per-row windowing: every labeled row (either label >= 0.01) becomes a
  (window, fnum) sample cut from the surrounding rows (:332,343);
- NaN screening of each window (:331-340);
- ``.ind`` sidecar mapping starting row -> fast5 file (:366-377).

Also reads the binary ``.xy.npz`` fast format written by
deepmod_tpu_torch.engine.getfeatures.
"""

from __future__ import annotations

import dataclasses
import glob as globmod
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TestSplit:
    """Holdout spec. mode '': none; 'P': fraction of files; 'E': genomic
    region [start, end) in Mb excluded from training."""

    mode: str = ""
    fraction: float = 1.0
    start: int = 0
    end: int = 0

    @classmethod
    def parse(cls, spec: Optional[str]) -> "TestSplit":
        """'E,1,2' or 'P,10' (DeepMod.py:212-222)."""
        if not spec:
            return cls()
        parts = spec.split(",")
        if parts[0] == "E":
            return cls(
                mode="E",
                start=int(parts[1]) * 10**6,
                end=int(parts[2]) * 10**6,
            )
        if parts[0] == "P":
            return cls(mode="P", fraction=int(parts[1]) / 100.0)
        raise ValueError(f"test split must start with E or P: {spec}")


def find_feature_files(
    folder: str, recursive: bool = True, split: Optional[TestSplit] = None,
    for_test: bool = False,
) -> List[str]:
    """Glob feature files; apply the P-mode file split (:234-247).

    P-mode with for_test=True returns the exact COMPLEMENT of the
    training slice — the held-out files (the reference never wired its
    test path up, so this side is defined here, not there).
    """
    files = globmod.glob(os.path.join(folder, "*.xy.gz"))
    if recursive:
        for depth in ("*/", "*/*/", "*/*/*/", "*/*/*/*/"):
            files.extend(globmod.glob(os.path.join(folder, depth + "*.xy.gz")))
    if not files:  # fall back to the binary format
        files = globmod.glob(os.path.join(folder, "*.xy.npz"))
        if recursive:
            for depth in ("*/", "*/*/", "*/*/*/", "*/*/*/*/"):
                files.extend(
                    globmod.glob(os.path.join(folder, depth + "*.xy.npz"))
                )
    files = sorted(files)
    if split and split.mode == "P":
        # train slice replicates myMultiBiRNN.py:244-247 exactly
        # (including the fraction<=0.5, n==0 whole-list quirk)
        if split.fraction > 0.5:
            train = files[: int(len(files) * split.fraction)]
        else:
            train = files[-int(len(files) * split.fraction) :]
        if for_test:
            train_set = set(train)
            return [f for f in files if f not in train_set]
        return train
    return files


def _read_matrix(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(matrix, exact_positions_or_None).

    A ``.xy.gz`` with a ``.xy.npz`` sibling loads the binary twin
    (~20x faster; the text is %.3f-formatted so the float32 binary holds
    the identical values). Text parses as float64 like the reference
    (myMultiBiRNN.py:306 np.loadtxt default) — float32 would corrupt
    genomic positions past 2^24 for the E-mode split.
    """
    if path.endswith(".xy.gz") and os.path.exists(path[:-6] + ".xy.npz"):
        path = path[:-6] + ".xy.npz"
    if path.endswith(".npz"):
        data = np.load(path)
        pos = (
            data["pos"].astype(np.int64) if "pos" in data.files else None
        )
        return data["xy"].astype(np.float32), pos
    import warnings

    with warnings.catch_warnings():
        # empty feature files are an intentional case (a read set with no
        # labeled sites flushes a header-free empty .xy.gz; the reference
        # loader tolerates it too) — silence only loadtxt's empty-input
        # UserWarning so real deprecations stay visible in test runs
        warnings.filterwarnings(
            "ignore", message=".*input contained no data.*",
            category=UserWarning,
        )
        return np.loadtxt(path, dtype=np.float64, ndmin=2), None


def load_feature_file(
    path: str,
    window_size: int = 21,
    split: Optional[TestSplit] = None,
    for_test: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """One feature file -> (X (N, window, fnum), Y (N, 2) int).

    E-mode: training keeps rows OUTSIDE [start, end); for_test=True keeps
    rows INSIDE (the reference's '-' / '+' modes, :326-329).
    """
    mdata, exact_pos = _read_matrix(path)
    if len(mdata) == 0:
        fnum = max(mdata.shape[1] - 3, 0) if mdata.ndim > 1 else 0
        return (
            np.empty((0, window_size, fnum), np.float32),
            np.empty((0, 2), np.int64),
        )
    t0 = exact_pos if exact_pos is not None else mdata[:, 0].astype(np.int64)
    ty = mdata[:, 1:3]
    tx = mdata[:, 3:]
    half = window_size // 2

    labeled = ~((ty[:, 0] < 0.01) & (ty[:, 1] < 0.01))
    if split and split.mode == "E":
        inside = (t0 > split.start) & (t0 < split.end)
        labeled &= inside if for_test else ~inside

    idx = np.flatnonzero(labeled)
    # windows must fit within the file (reference windows never clip
    # because of the +-25 truncation margins; guard anyway)
    idx = idx[(idx >= half) & (idx < len(mdata) - half)]
    if len(idx) == 0:
        return (
            np.empty((0, window_size, tx.shape[1]), np.float32),
            np.empty((0, 2), np.int64),
        )

    view = np.lib.stride_tricks.sliding_window_view(tx, window_size, axis=0)
    windows = np.moveaxis(view[idx - half], 2, 1)
    # NaN screening (:331-340): drop samples whose window contains NaN
    ok = ~np.isnan(windows).any(axis=(1, 2))
    return (
        np.ascontiguousarray(windows[ok], np.float32),
        ty[idx][ok].astype(np.int64),
    )


def read_ind_sidecar(path: str) -> List[Tuple[int, str]]:
    """.xy.ind sidecar: (starting row, fast5 path) (:366-377)."""
    base = path
    for suffix in (".xy.gz", ".xy.npz"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    out: List[Tuple[int, str]] = []
    with open(base + ".xy.ind") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) > 1:
                out.append((int(parts[0]), parts[1]))
    return out


def iterate_training_batches(
    file_groups: Sequence[Sequence[str]],
    batch_size: int = 2048,
    window_size: int = 21,
    split: Optional[TestSplit] = None,
    chunk_files: int = 25,
    rebalance: bool = True,
    progress: Optional[dict] = None,
) -> Iterator[List[Tuple[np.ndarray, np.ndarray]]]:
    """Yield interleaved minibatch groups, group 0 driving the epoch.

    Follows the reference's super-batch structure (train_save_model,
    myMultiBiRNN.py:128-172): load ~chunk_files x batch_size rows of group
    0, split into minibatches; give every other group the same number of
    minibatches (cycling through its files); yield one list per step with
    one (X, Y) minibatch per group.

    ``progress`` (optional dict) gets ``files_consumed`` set to group 0's
    file cursor after each super-batch — the unit the reference's
    mid-epoch checkpoint trigger counts (myMultiBiRNN.py:210-214).
    """
    n_groups = len(file_groups)
    cursors = [0] * n_groups

    def load_until(group: int, min_rows: int, wrap: bool) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        rows = 0
        files = file_groups[group]
        read_since_progress = 0
        while rows < min_rows:
            if cursors[group] >= len(files):
                if wrap and len(files) > 0 and read_since_progress < len(files):
                    # stop wrapping after a full pass with zero labeled
                    # rows (e.g. every row held out by the split) — the
                    # loop must not re-read the same files forever
                    cursors[group] = 0
                else:
                    break
            x, y = load_feature_file(files[cursors[group]], window_size, split)
            cursors[group] += 1
            if len(y):
                xs.append(x)
                ys.append(y)
                rows += len(y)
                read_since_progress = 0
            else:
                read_since_progress += 1
        if not xs:
            return (
                np.empty((0, window_size, 0), np.float32),
                np.empty((0, 2), np.int64),
            )
        return np.concatenate(xs), np.concatenate(ys)

    while cursors[0] < len(file_groups[0]):
        x0, y0 = load_until(0, batch_size * chunk_files, wrap=False)
        if len(y0) < 1:
            break
        n_batches = max(1, len(y0) // batch_size)
        x0_parts = np.array_split(x0, n_batches)
        y0_parts = np.array_split(y0, n_batches)
        others = []
        for group in range(1, n_groups):
            xg, yg = load_until(group, batch_size * n_batches, wrap=True)
            if rebalance and len(y0) < batch_size * chunk_files * 0.8:
                cap = int(len(y0) * 1.2)
                xg, yg = xg[:cap], yg[:cap]
            if len(yg):
                others.append(
                    (np.array_split(xg, n_batches), np.array_split(yg, n_batches))
                )
            else:
                others.append(None)
        if progress is not None:
            progress["files_consumed"] = cursors[0]
        for i in range(n_batches):
            step = [(x0_parts[i], y0_parts[i])]
            for grp in others:
                if grp is not None and len(grp[1][i]):
                    step.append((grp[0][i], grp[1][i]))
            yield step
