"""Reference-genome FASTA access.

The reference fetches chromosome sequences by shelling out to
``samtools faidx`` once per chromosome (myDetect.py:470-483) or parsing
the whole FASTA in Python (myGetFeatureBasedPos.py:588-610). Here a
single ``FastaReference`` provides both access patterns in-process:

- builds/uses a standard ``.fai`` index for random access (the samtools
  index format: name, length, offset, linebases, linewidth);
- memory-maps the file so per-chromosome fetches are zero-copy until
  uppercased;
- caches fetched chromosomes like the reference's ``sp_param['ref_info']``.

Sequences are returned uppercased, matching ``readFA``
(myGetFeatureBasedPos.py:602) and the faidx path (myDetect.py:483).
"""

from __future__ import annotations

import mmap
import os
from typing import Dict, Iterator, List, Tuple


def build_fai_index(fasta_path: str, fai_path: str | None = None) -> Dict[str, Tuple[int, int, int, int]]:
    """Build a samtools-format .fai index: name -> (length, offset, linebases, linewidth)."""
    index: Dict[str, Tuple[int, int, int, int]] = {}
    order: List[str] = []
    with open(fasta_path, "rb") as fh:
        name = None
        seq_len = 0
        seq_offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        prev_short = False
        offset = 0
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    index[name] = (seq_len, seq_offset, linebases, linewidth)
                    order.append(name)
                name = raw[1:].split()[0].decode()
                seq_len = 0
                seq_offset = offset + len(raw)
                first_line = True
                prev_short = False
            elif name is not None and line:
                if first_line:
                    linebases = len(line)
                    linewidth = len(raw)
                    first_line = False
                elif len(line) > linebases or prev_short:
                    # non-uniform line lengths break the offset arithmetic
                    # fetch() relies on; samtools faidx refuses such files
                    # too — fail loudly instead of returning shifted bases
                    raise ValueError(
                        f"{fasta_path}: record {name!r} has non-uniform "
                        "line lengths; cannot build a .fai index"
                    )
                prev_short = len(line) < linebases
                seq_len += len(line)
            elif name is not None and not line and not first_line:
                prev_short = True  # blank line inside a record
            offset += len(raw)
        if name is not None:
            index[name] = (seq_len, seq_offset, linebases, linewidth)
            order.append(name)
    if fai_path is None:
        fai_path = fasta_path + ".fai"
    try:
        with open(fai_path, "w") as out:
            for nm in order:
                ln, off, lb, lw = index[nm]
                out.write(f"{nm}\t{ln}\t{off}\t{lb}\t{lw}\n")
    except OSError:
        pass  # read-only location; index stays in memory
    return index


def _load_fai(fai_path: str) -> Dict[str, Tuple[int, int, int, int]]:
    index: Dict[str, Tuple[int, int, int, int]] = {}
    with open(fai_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 5:
                index[parts[0]] = (
                    int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])
                )
    return index


class FastaReference:
    """Indexed, cached access to a reference FASTA."""

    def __init__(self, fasta_path: str):
        self.path = fasta_path
        fai = fasta_path + ".fai"
        if os.path.isfile(fai) and os.path.getmtime(fai) >= os.path.getmtime(fasta_path):
            self.index = _load_fai(fai)
        else:
            self.index = build_fai_index(fasta_path)
        self._fh = open(fasta_path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._cache: Dict[str, str] = {}

    def close(self) -> None:
        self._mm.close()
        self._fh.close()

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def names(self) -> List[str]:
        return list(self.index.keys())

    def length(self, name: str) -> int:
        return self.index[name][0]

    def fetch(self, name: str) -> str:
        """Whole-chromosome sequence, uppercased (cached)."""
        if name in self._cache:
            return self._cache[name]
        length, offset, linebases, linewidth = self.index[name]
        nlines = (length + linebases - 1) // linebases if linebases else 0
        raw = self._mm[offset : offset + length + nlines * (linewidth - linebases)]
        seq = raw.replace(b"\n", b"").replace(b"\r", b"").decode().upper()
        seq = seq[:length]
        self._cache[name] = seq
        return seq

    def fetch_region(self, name: str, start: int, end: int) -> str:
        """[start, end) slice in 0-based coordinates."""
        return self.fetch(name)[start:end]


def read_fasta(path: str, only_chr: str | None = None) -> Dict[str, str]:
    """Parse a whole FASTA into a dict (readFA equivalent,
    myGetFeatureBasedPos.py:588-610)."""
    out: Dict[str, str] = {}
    name = None
    chunks: List[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None and (only_chr in (None, name)):
                    out[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif only_chr in (None, name):
                chunks.append(line.upper())
        if name is not None and (only_chr in (None, name)):
            out[name] = "".join(chunks)
    return out


def write_fasta(path: str, seqs: Dict[str, str], width: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    for name, seq in read_fasta(path).items():
        yield name, seq
