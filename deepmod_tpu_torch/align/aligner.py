"""Aligner backends behind one interface.

The reference writes event-derived basecalls to a temp FASTA and shells
out to ``minimap2 -ax map-ont`` or ``bwa mem -x ont2d`` per batch
(myDetect.py:397-424, myGetFeatureBasedPos.py:44-62). Backends here:

- ``ExternalAligner``: the same subprocess contract, used when the binary
  exists (flag-compatible with the reference's --alignStr);
- ``BuiltinAligner`` via ``MinimizerAligner``: in-process seed-chain-extend
  (deepmod_tpu_torch.align.minimizer), with an optional C++ native core
  (deepmod_tpu_torch.native) when built — no temp files, no subprocesses;
- ``get_aligner('auto')`` prefers the external binary if present and falls
  back to the built-in mapper.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional

from deepmod_tpu_torch.io.fasta import read_fasta
from .minimizer import BuiltinAligner, MinimizerIndex
from .sam import SamRecord, parse_sam_line


class AlignerBase:
    def align(self, reads: Dict[str, str]) -> List[SamRecord]:
        raise NotImplementedError


class ExternalAligner(AlignerBase):
    """minimap2/bwa subprocess with the reference's exact flags."""

    def __init__(self, ref_fasta_path: str, tool: str = "minimap2"):
        self.ref_path = ref_fasta_path
        self.tool = tool

    def align(self, reads: Dict[str, str]) -> List[SamRecord]:
        with tempfile.NamedTemporaryFile(suffix=".fa", mode="w") as fa:
            for name in sorted(reads):
                fa.write(f">{name}\n{reads[name]}\n")
            fa.flush()
            if self.tool == "bwa":
                cmd = ["bwa", "mem", "-x", "ont2d", "-v", "1", "-t", "1",
                       self.ref_path, fa.name]
            else:
                cmd = ["minimap2", "-ax", "map-ont", self.ref_path, fa.name]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"aligner {self.tool} failed rc={proc.returncode}: "
                    f"{proc.stderr[-500:]}"
                )
        records = []
        for line in proc.stdout.splitlines():
            rec = parse_sam_line(line)
            if rec is not None:
                records.append(rec)
        return records


class MinimizerAligner(AlignerBase):
    """In-process built-in mapper over a shared MinimizerIndex."""

    def __init__(self, ref_seqs: Dict[str, str], k: int = 15, w: int = 10):
        self.index = MinimizerIndex(ref_seqs, k=k, w=w)
        self._mapper = BuiltinAligner(self.index)

    def align(self, reads: Dict[str, str]) -> List[SamRecord]:
        records = []
        for name in sorted(reads):
            rec = self._mapper.map_read(name, reads[name])
            if rec is not None:
                records.append(rec)
        return records


_INDEX_CACHE: Dict[str, MinimizerAligner] = {}
_PREALIGNED_CACHE: Dict[str, AlignerBase] = {}


def get_aligner(
    ref_fasta_path: str,
    tool: str = "auto",
    ref_seqs: Optional[Dict[str, str]] = None,
) -> AlignerBase:
    """Resolve an aligner backend.

    tool: 'minimap2' | 'bwa' | 'builtin' | 'auto' | path to a .sam/.bam.
    'auto' uses minimap2 or bwa if installed, else the built-in mapper.
    A .sam/.sam.gz/.bam path skips alignment entirely and serves records
    from that file (align.alignfile.PrealignedAligner — beyond the
    reference, which always re-aligns in-pipeline). Built-in indexes and
    pre-aligned lookups are cached per path (mirrors each reference
    worker building its index once per process).
    """
    if tool.endswith((".sam", ".sam.gz", ".bam")):
        if tool in _PREALIGNED_CACHE:
            return _PREALIGNED_CACHE[tool]
        from .alignfile import PrealignedAligner

        aligner = PrealignedAligner(tool)
        _PREALIGNED_CACHE[tool] = aligner
        return aligner
    if tool in ("minimap2", "bwa"):
        if shutil.which(tool) is None:
            raise FileNotFoundError(
                f"--alignStr {tool} requested but '{tool}' is not installed; "
                "use the built-in aligner (alignStr=builtin)"
            )
        return ExternalAligner(ref_fasta_path, tool)
    if tool not in ("auto", "builtin"):
        raise ValueError(
            f"--alignStr {tool!r}: expected bwa|minimap2|builtin|auto or a "
            ".sam/.sam.gz/.bam path"
        )
    if tool == "auto":
        for candidate in ("minimap2", "bwa"):
            if shutil.which(candidate):
                return ExternalAligner(ref_fasta_path, candidate)
    # builtin
    if ref_fasta_path in _INDEX_CACHE:
        return _INDEX_CACHE[ref_fasta_path]
    seqs = ref_seqs if ref_seqs is not None else read_fasta(ref_fasta_path)
    aligner = MinimizerAligner(seqs)
    _INDEX_CACHE[ref_fasta_path] = aligner
    return aligner
