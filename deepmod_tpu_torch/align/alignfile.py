"""Pre-aligned input: consume SAM/BAM alignments instead of aligning.

Beyond the reference (which always writes a temp FASTA of event-derived
basecalls and shells out to minimap2/bwa in-pipeline, myDetect.py:397-424):
modern basecaller workflows already carry aligned BAMs, so detect and
getfeatures accept ``--alignFile`` and skip the alignment stage entirely.

The BAM decoder is self-contained (no pysam/htslib): BGZF is a stream of
concatenated gzip members, which :mod:`gzip` reads transparently, and the
record layout follows the SAM/BAM spec (SAMv1.pdf §4.2). Records pass
through the SAME best-mapq sanity filter as in-pipeline SAM
(align.sam.filter_best_alignments, myDetect.py:929-943); secondary and
supplementary records (flag 0x100/0x800) are dropped up front because
their SEQ is absent or hard-clipped.

Requirement: the alignment file must have been produced from the same
basecalls the fast5s carry — downstream consistency checks
(features.builder) reject reads whose aligned SEQ disagrees with the
event-derived basecall.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

from .sam import SamRecord, filter_best_alignments, parse_sam_line

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SKIP_FLAGS = 0x900  # secondary | supplementary


def _read_exact(fh, n: int) -> bytes:
    buf = fh.read(n)
    while len(buf) < n:
        chunk = fh.read(n - len(buf))
        if not chunk:
            raise ValueError("truncated BAM stream")
        buf += chunk
    return buf


_TAG_SIZES = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
_ARRAY_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _find_cg_tag(rec: bytes, off: int):
    """Scan BAM aux data for the CG:B,I tag (real CIGAR ops); None if
    absent or malformed."""
    n = len(rec)
    while off + 3 <= n:
        tag = rec[off : off + 2]
        val_type = chr(rec[off + 2])
        off += 3
        if val_type == "B":
            if off + 5 > n:
                return None
            sub = chr(rec[off])
            (count,) = struct.unpack_from("<i", rec, off + 1)
            off += 5
            width = _ARRAY_SIZES.get(sub)
            if width is None:
                return None
            if tag == b"CG" and sub == "I":
                return struct.unpack_from(f"<{count}I", rec, off)
            off += width * count
        elif val_type == "Z" or val_type == "H":
            end = rec.find(b"\x00", off)
            if end < 0:
                return None
            off = end + 1
        else:
            width = _TAG_SIZES.get(val_type)
            if width is None:
                return None
            off += width
    return None


def iter_bam(path: str) -> Iterator[SamRecord]:
    """Stream primary alignment records from a BAM file."""
    with gzip.open(path, "rb") as fh:
        if _read_exact(fh, 4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", _read_exact(fh, 4))
        _read_exact(fh, l_text)  # header text (unused)
        (n_ref,) = struct.unpack("<i", _read_exact(fh, 4))
        ref_names = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(fh, 4))
            name = _read_exact(fh, l_name)[:-1].decode()
            _read_exact(fh, 4)  # l_ref
            ref_names.append(name)
        while True:
            head = fh.read(4)
            if not head:
                return
            if len(head) < 4:
                raise ValueError("truncated BAM record")
            (block_size,) = struct.unpack("<i", head)
            rec = _read_exact(fh, block_size)
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
             l_seq, _next_ref, _next_pos, _tlen) = struct.unpack(
                "<iiBBHHHiiii", rec[:32]
            )
            if flag & _SKIP_FLAGS:
                continue
            off = 32
            qname = rec[off : off + l_read_name - 1].decode()
            off += l_read_name
            cigar_ops = struct.unpack_from(f"<{n_cigar}I", rec, off)
            off += 4 * n_cigar
            # >65535-op CIGARs (ultra-long reads) are stored as a kSmN
            # placeholder with the real ops in the CG:B,I tag (SAM spec
            # §4.2); recover them or drop the record rather than garble it
            if (
                n_cigar == 2
                and (cigar_ops[0] & 0xF) == 4   # S
                and (cigar_ops[1] & 0xF) == 3   # N
                and (cigar_ops[0] >> 4) == l_seq
            ):
                aux_off = off + (l_seq + 1) // 2 + l_seq
                real = _find_cg_tag(rec, aux_off)
                if real is None:
                    continue
                cigar_ops = real
            cigar = (
                "".join(
                    f"{op >> 4}{_CIGAR_OPS[op & 0xF]}" for op in cigar_ops
                )
                or "*"
            )
            # BAM's op nibble order IS cigar._OPS order, so the packed runs
            # are already the pre-parsed arrays expand_alignment wants
            if cigar_ops:
                packed = np.asarray(cigar_ops, np.int64)
                cigar_arrays = (packed >> 4, packed & 0xF)
            else:
                cigar_arrays = None
            n_seq_bytes = (l_seq + 1) // 2
            seq_packed = rec[off : off + n_seq_bytes]
            seq_chars = []
            for byte in seq_packed:
                seq_chars.append(_SEQ_CODES[byte >> 4])
                seq_chars.append(_SEQ_CODES[byte & 0xF])
            seq = "".join(seq_chars[:l_seq]) if l_seq else "*"
            yield SamRecord(
                qname=qname,
                flag=flag,
                rname=ref_names[ref_id] if 0 <= ref_id < n_ref else "*",
                pos=pos + 1,  # BAM is 0-based, SamRecord follows SAM
                mapq=mapq,
                cigar=cigar,
                seq=seq,
                cigar_arrays=cigar_arrays,
            )


def iter_sam(path: str) -> Iterator[SamRecord]:
    """Stream records from a SAM text file (.sam or .sam.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:  # type: ignore[operator]
        for line in fh:
            rec = parse_sam_line(line)
            if rec is not None and not rec.flag & _SKIP_FLAGS:
                yield rec


def iter_alignment_file(path: str) -> Iterator[SamRecord]:
    if path.endswith(".bam"):
        return iter_bam(path)
    return iter_sam(path)


class PrealignedAligner:
    """AlignerBase-compatible lookup over a SAM/BAM file.

    The file is scanned ONCE at construction (per worker, like the
    built-in aligner's index build), keeping only the best-mapq primary
    record per qname — memory is one record per read, not per alignment.
    """

    def __init__(self, path: str):
        self.path = path
        # same best-mapq sanity filter as in-pipeline SAM; the iterator is
        # lazy, so memory stays one record per read
        self._by_qname = filter_best_alignments(iter_alignment_file(path))

    def align(self, reads: Dict[str, str]):
        """Return records for the requested read ids.

        fast5 read ids are the full fastq header with spaces mapped to
        ':::' (io.fast5); BAM/SAM qnames are the first header token, so
        both spellings resolve. Returned qnames are rewritten to the
        requested id so downstream keying is uniform.
        """
        out = []
        for rid in sorted(reads):
            rec = self._by_qname.get(rid)
            if rec is None:
                rec = self._by_qname.get(rid.split(":::", 1)[0])
            if rec is not None:
                out.append(
                    SamRecord(
                        qname=rid,
                        flag=rec.flag,
                        rname=rec.rname,
                        pos=rec.pos,
                        mapq=rec.mapq,
                        cigar=rec.cigar,
                        seq=rec.seq,
                        cigar_arrays=rec.cigar_arrays,
                    )
                )
        return out


# ---------------------------------------------------------------------------
# BAM writing (BGZF blocks) — used by tests and for exporting alignments.


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25  # total block length - 1
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<HH", 2, bsize)
        + cdata
        + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    )


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _encode_record(rec: SamRecord, ref_ids: Dict[str, int]) -> bytes:
    name = rec.qname.encode() + b"\x00"
    cigar_ops = []
    if rec.cigar != "*":
        num = 0
        for ch in rec.cigar:
            if ch.isdigit():
                num = num * 10 + ord(ch) - 48
            else:
                cigar_ops.append((num << 4) | _CIGAR_OPS.index(ch))
                num = 0
    seq = rec.seq if rec.seq != "*" else ""
    aux = b""
    if len(cigar_ops) > 0xFFFF:
        # n_cigar_op is uint16: store the kSmN placeholder + CG:B,I tag
        # (SAM spec §4.2), like htslib does for ultra-long alignments
        ref_len = sum(
            op >> 4 for op in cigar_ops if _CIGAR_OPS[op & 0xF] in "MDN=X"
        )
        aux = (
            b"CGBI"
            + struct.pack("<i", len(cigar_ops))
            + struct.pack(f"<{len(cigar_ops)}I", *cigar_ops)
        )
        cigar_ops = [(len(seq) << 4) | 4, (ref_len << 4) | 3]  # kS mN
    packed = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        code = _SEQ_CODES.index(base) if base in _SEQ_CODES else 15
        packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            ref_ids.get(rec.rname, -1),
            rec.pos - 1,
            len(name),
            rec.mapq,
            0,
            len(cigar_ops),
            rec.flag,
            len(seq),
            -1,
            -1,
            0,
        )
        + name
        + struct.pack(f"<{len(cigar_ops)}I", *cigar_ops)
        + bytes(packed)
        + b"\xff" * len(seq)
        + aux
    )
    return struct.pack("<i", len(body)) + body


def write_bam(
    path: str,
    refs: Iterable[Tuple[str, int]],
    records: Iterable[SamRecord],
) -> None:
    """Minimal BAM writer: refs = [(name, length)], records in any order."""
    refs = list(refs)
    ref_ids = {name: i for i, (name, _) in enumerate(refs)}
    header_text = (
        "@HD\tVN:1.6\n"
        + "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs)
    ).encode()
    payload = bytearray()
    payload += b"BAM\x01"
    payload += struct.pack("<i", len(header_text)) + header_text
    payload += struct.pack("<i", len(refs))
    for name, length in refs:
        nm = name.encode() + b"\x00"
        payload += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
    for rec in records:
        payload += _encode_record(rec, ref_ids)
    with open(path, "wb") as fh:
        # split into <=60KB BGZF blocks (spec caps a block at 64KB)
        chunk = 60 * 1024
        for i in range(0, len(payload), chunk):
            fh.write(_bgzf_block(bytes(payload[i : i + chunk])))
        fh.write(_BGZF_EOF)


# ---------------------------------------------------------------------------
# Basecall tables from dorado-style BAMs: per-read sequence + move table
# (``mv:B:c`` — first element is the model stride, then one 0/1 flag per
# signal block) and the signal trim offset (``ts:i``). This is the modern
# ONT basecall convention; paired with a .pod5 it replaces the fast5
# Move/Segmentation datasets (io.fast5.read_pod5_batch).


class BasecallRecord:
    __slots__ = ("read_id", "seq", "stride", "moves", "trim")

    def __init__(self, read_id, seq, stride, moves, trim):
        self.read_id = read_id
        self.seq = seq
        self.stride = stride
        self.moves = moves
        self.trim = trim


def _scan_aux(rec: bytes, off: int) -> Dict[bytes, object]:
    """All aux tags of one BAM record -> {tag: value} (B arrays as
    numpy; unknown value types abort the scan)."""
    out: Dict[bytes, object] = {}
    n = len(rec)
    while off + 3 <= n:
        tag = rec[off : off + 2]
        val_type = chr(rec[off + 2])
        off += 3
        if val_type == "B":
            sub = chr(rec[off])
            (count,) = struct.unpack_from("<i", rec, off + 1)
            off += 5
            width = _ARRAY_SIZES.get(sub)
            if width is None:
                break
            dt = {"c": np.int8, "C": np.uint8, "s": np.int16,
                  "S": np.uint16, "i": np.int32, "I": np.uint32,
                  "f": np.float32}[sub]
            out[tag] = np.frombuffer(rec, dt, count, off)
            off += width * count
        elif val_type in ("Z", "H"):
            end = rec.find(b"\x00", off)
            if end < 0:
                break
            out[tag] = rec[off:end].decode()
            off = end + 1
        elif val_type == "A":
            out[tag] = chr(rec[off])
            off += 1
        else:
            width = _TAG_SIZES.get(val_type)
            if width is None:
                break
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H",
                   "i": "i", "I": "I", "f": "f"}[val_type]
            out[tag] = struct.unpack_from("<" + fmt, rec, off)[0]
            off += width
    return out


def read_basecalls(path: str) -> Dict[str, BasecallRecord]:
    """read_id -> BasecallRecord from a BAM (or SAM/.sam.gz) carrying
    mv/ts tags. Records without an mv tag are skipped; unmapped (flag 4)
    records are included — a basecall BAM need not be aligned."""
    out: Dict[str, BasecallRecord] = {}
    if not path.endswith(".bam"):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:  # type: ignore[operator]
            for line in fh:
                if line.startswith("@"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 11 or int(parts[1]) & _SKIP_FLAGS:
                    continue
                mv = None
                ts = 0
                for tagf in parts[11:]:
                    if tagf.startswith("mv:B:c,"):
                        mv = np.asarray(
                            [int(x) for x in tagf[7:].split(",")], np.int8
                        )
                    elif tagf.startswith("ts:i:"):
                        ts = int(tagf[5:])
                if mv is not None and len(mv) >= 2:
                    out[parts[0]] = BasecallRecord(
                        parts[0], parts[9], int(mv[0]),
                        np.asarray(mv[1:], np.int64), ts,
                    )
        return out

    with gzip.open(path, "rb") as fh:
        if _read_exact(fh, 4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", _read_exact(fh, 4))
        _read_exact(fh, l_text)
        (n_ref,) = struct.unpack("<i", _read_exact(fh, 4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(fh, 4))
            _read_exact(fh, l_name + 4)
        while True:
            head = fh.read(4)
            if not head:
                break
            (block_size,) = struct.unpack("<i", head)
            rec = _read_exact(fh, block_size)
            (_ref_id, _pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _nr, _np_, _tl) = struct.unpack("<iiBBHHHiiii", rec[:32])
            if flag & _SKIP_FLAGS:
                continue
            off = 32
            qname = rec[off : off + l_read_name - 1].decode()
            off += l_read_name + 4 * n_cigar
            n_seq_bytes = (l_seq + 1) // 2
            seq_packed = rec[off : off + n_seq_bytes]
            seq_chars = []
            for byte in seq_packed:
                seq_chars.append(_SEQ_CODES[byte >> 4])
                seq_chars.append(_SEQ_CODES[byte & 0xF])
            seq = "".join(seq_chars[:l_seq])
            aux = _scan_aux(rec, off + n_seq_bytes + l_seq)
            mv = aux.get(b"mv")
            if mv is None or len(mv) < 2:
                continue
            out[qname] = BasecallRecord(
                qname, seq, int(mv[0]),
                np.asarray(mv[1:], np.int64), int(aux.get(b"ts", 0)),
            )
    return out


def write_basecall_bam(
    path: str,
    reads: Iterable[Tuple[str, str, int, "np.ndarray", int]],
) -> None:
    """Fixture/export writer: unmapped records with mv:B:c + ts:i tags.

    ``reads``: (read_id, seq, stride, moves 0/1 array, trim_samples).
    """
    payload = bytearray()
    payload += b"BAM\x01"
    header_text = b"@HD\tVN:1.6\n"
    payload += struct.pack("<i", len(header_text)) + header_text
    payload += struct.pack("<i", 0)  # no references (unmapped basecalls)
    for read_id, seq, stride, moves, trim in reads:
        name = read_id.encode() + b"\x00"
        packed = bytearray((len(seq) + 1) // 2)
        for i, base in enumerate(seq):
            code = _SEQ_CODES.index(base) if base in _SEQ_CODES else 15
            packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
        mv = np.concatenate(
            [[np.int8(stride)], np.asarray(moves, np.int8)]
        ).astype(np.int8)
        aux = (
            b"mvBc" + struct.pack("<i", len(mv)) + mv.tobytes()
            + b"tsi" + struct.pack("<i", int(trim))
        )
        body = (
            struct.pack(
                "<iiBBHHHiiii", -1, -1, len(name), 255, 0, 0, 4,
                len(seq), -1, -1, 0,
            )
            + name
            + bytes(packed)
            + b"\xff" * len(seq)
            + aux
        )
        payload += struct.pack("<i", len(body)) + body
    with open(path, "wb") as fh:
        chunk = 60 * 1024
        for i in range(0, len(payload), chunk):
            fh.write(_bgzf_block(bytes(payload[i : i + chunk])))
        fh.write(_BGZF_EOF)
