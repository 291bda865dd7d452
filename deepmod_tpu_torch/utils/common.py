"""Shared constants and small helpers.

Mirrors the role of the reference's shared-constants module
(bin/DeepMod_scripts/myCom.py:1-56): output levels, base-pair complement
map, the A/C/G/T one-hot order, and folder normalization — plus the error
census the reference keeps as an ``sp_options['Error']`` dict
(myDetect.py:353-386, 1222-1226).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

# Output verbosity levels (myCom.py:5-8).
OUTPUT_DEBUG = 0
OUTPUT_INFO = 1
OUTPUT_WARNING = 2
OUTPUT_ERROR = 3

# One-hot base order used by the feature builder (myCom.py:26,
# myDetect.py:894-895).
G_ACGT: List[str] = ["A", "C", "G", "T"]
BASE_TO_INDEX: Dict[str, int] = {b: i for i, b in enumerate(G_ACGT)}

# Case-preserving complement map (myCom.py:14-24); bases outside the map
# complement to themselves (myDetect.py:915-917).
COMPLEMENT: Dict[str, str] = {
    "A": "T", "C": "G", "G": "C", "T": "A",
    "a": "t", "c": "g", "g": "c", "t": "a",
    "N": "N", "n": "n",
}

# Vectorized complement over uint8 ASCII codes: identity except ACGTacgt/Nn.
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _k, _v in COMPLEMENT.items():
    _COMP_TABLE[ord(_k)] = ord(_v)


def complement_base(base: str) -> str:
    """Complement of a single base; unknown bases map to themselves."""
    return COMPLEMENT.get(base, base)


def complement_seq(seq: str) -> str:
    """Per-character complement (no reversal)."""
    return seq.translate(str.maketrans(COMPLEMENT))


def reverse_complement(seq: str) -> str:
    return complement_seq(seq)[::-1]


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """Complement an array of uint8 ASCII base codes."""
    return _COMP_TABLE[codes]


def format_folder(path: str | None) -> str | None:
    """Normalize a folder path to end with '/' (myCom.py:42-46)."""
    if path is None:
        return None
    if path.endswith("/"):
        return path
    if path.endswith("\\"):
        return path[:-1] + "/"
    return path + "/"


class ErrorCensus:
    """Per-file failure classification.

    The reference never lets one bad fast5 kill a worker: failures are
    recorded per error class and counted at the end (myDetect.py:353-386,
    979-980, 1222-1226). This is the structured equivalent.
    """

    def __init__(self) -> None:
        self._errors: Dict[str, List[str]] = defaultdict(list)

    def add(self, error_kind: str, path: str) -> None:
        self._errors[error_kind].append(path)

    def extend(self, error_kind: str, paths: List[str]) -> None:
        self._errors[error_kind].extend(paths)

    def merge(self, other: "ErrorCensus") -> None:
        for kind, paths in other._errors.items():
            self._errors[kind].extend(paths)

    @property
    def errors(self) -> Dict[str, List[str]]:
        return dict(self._errors)

    def counts(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._errors.items()}

    def total(self) -> int:
        return sum(len(v) for v in self._errors.values())

    def summary(self) -> str:
        if not self._errors:
            return "no per-file errors"
        lines = ["per-file error census:"]
        for kind, paths in sorted(self._errors.items()):
            lines.append(f"  {kind}: {len(paths)}")
        return "\n".join(lines)
