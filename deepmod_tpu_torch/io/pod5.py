"""POD5 container slice: Arrow-IPC-framed signal/reads/run-info tables.

The reference scopes POD5 out entirely (README.md:24 limits DeepMod to
single-read fast5; docs/Install.md:50 only acknowledges the vbz plugin),
but it is the modern ONT signal container, so this framework carries a
spec-derived slice — built the same way as io/vbz.py:

- the container framing (8-byte signature, section markers, embedded
  Arrow IPC files, flatbuffer footer with a trailing length + repeated
  signature) follows the published pod5-file-format specification;
- each embedded table is a genuine Arrow IPC *file* (ARROW1 magic,
  flatbuffer Schema/RecordBatch messages, file footer) written and read
  by the minimal flatbuffer/Arrow implementation below — Apache Arrow's
  format documents are public and stable;
- signal rows are VBZ-compressed through deepmod_tpu_torch.io.vbz (zigzag
  delta + StreamVByte + zstd, spec-vector-pinned) in ``large_binary``
  columns, or uncompressed ``large_list<int16>``.

Validation: no pod5 library is a dependency, so these bytes are
validated against the written specifications and round-trip tests, not
against a vendor-produced file. The reads-table column subset is the minimum the
ingestion path needs (read_id, signal row indices, calibration, run-info
index, read_number, start, median_before); pod5's full reads table
carries more columns, which the reader skips by name. First action when
a real .pod5 is obtainable: read it with this module, byte-compare our
writer's Arrow framing against pyarrow's, and pin both as golden.

POD5 holds RAW signal only — no basecalls or events — so end-to-end
ingestion pairs a .pod5 with a basecall source carrying per-read
sequence + move tables (the dorado convention: BAM ``mv:B:c`` stride +
moves, ``ts:i`` trim; see io/fast5.py::read_pod5_batch).
"""

from __future__ import annotations

import struct
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

POD5_SIGNATURE = bytes([0x8B, 0x50, 0x4F, 0x44, 0x0D, 0x0A, 0x1A, 0x0A])
ARROW_MAGIC = b"ARROW1"

# pod5 footer.fbs enums (spec-derived; see honesty statement)
FORMAT_FEATHER_V2 = 0
CONTENT_READS = 0
CONTENT_SIGNAL = 1
CONTENT_RUN_INFO = 2

# Arrow flatbuffer enum values (format/Schema.fbs, format/Message.fbs)
TYPE_INT = 2
TYPE_FLOATING_POINT = 3
TYPE_UTF8 = 5
TYPE_FIXED_SIZE_BINARY = 15
TYPE_LARGE_BINARY = 19
TYPE_LARGE_LIST = 21
MSG_SCHEMA = 1
MSG_RECORD_BATCH = 3
FP_SINGLE = 1  # FloatingPoint.precision enum


# --------------------------------------------------------------------------
# minimal flatbuffers (little-endian; build back-to-front like the
# official builders so uoffsets stay forward-pointing)


class FBBuilder:
    def __init__(self) -> None:
        self._buf = bytearray()

    def _prepend(self, data: bytes) -> None:
        self._buf[0:0] = data

    def _prep(self, align: int, extra: int) -> None:
        while (len(self._buf) + extra) % align:
            self._buf[0:0] = b"\0"

    def scalar(self, fmt: str, value) -> None:
        data = struct.pack("<" + fmt, value)
        self._prep(len(data), 0)
        self._prepend(data)

    def offset_here(self) -> int:
        """End-relative offset of the most recently written object."""
        return len(self._buf)

    def uoffset(self, target: int) -> None:
        self._prep(4, 0)
        self._prepend(struct.pack("<I", len(self._buf) + 4 - target))

    def bytes_vec(self, data: bytes, elem_size: int = 1,
                  trailing_nul: bool = False) -> int:
        # vector layout [len u32][elements][nul?] must be CONTIGUOUS:
        # alignment padding goes after the tail (prepended first), never
        # between the parts
        tail = b"\0" if trailing_nul else b""
        self._prep(max(4, elem_size), 4 + len(data) + len(tail))
        self._prepend(tail)
        self._prepend(data)
        self._prepend(struct.pack("<I", len(data) // elem_size))
        return self.offset_here()

    def string(self, text: str) -> int:
        return self.bytes_vec(text.encode(), trailing_nul=True)

    def offset_vec(self, offsets: Sequence[int]) -> int:
        self._prep(4, 4 * len(offsets) + 4)
        for off in reversed(offsets):
            self._prepend(struct.pack("<I", len(self._buf) + 4 - off))
        self._prepend(struct.pack("<I", len(offsets)))
        return self.offset_here()

    def struct_vec(self, packed: bytes, count: int, align: int) -> int:
        self._prep(max(align, 4), len(packed) + 4)
        self._prepend(packed)
        self._prepend(struct.pack("<I", count))
        return self.offset_here()

    def table(self, fields: Dict[int, Tuple[str, Any]]) -> int:
        """fields: {field_id: (kind, value)} — kind is a struct fmt char
        for inline scalars, 'o' for a previously-built offset, or 's' for
        inline pre-packed struct bytes. Returns the table's offset."""
        start_len = len(self._buf)
        slots: Dict[int, int] = {}
        for fid in sorted(fields, reverse=True):
            kind, value = fields[fid]
            if kind == "o":
                self.uoffset(value)
            elif kind == "s":
                self._prep(8, 0)
                self._prepend(value)
            else:
                self.scalar(kind, value)
            slots[fid] = len(self._buf)
        # table start: the int32 soffset to the vtable
        self._prep(4, 0)
        self._prepend(b"\0\0\0\0")  # placeholder soffset
        table_off = len(self._buf)
        n_slots = (max(fields) + 1) if fields else 0
        vt = bytearray()
        vt += struct.pack("<H", 4 + 2 * n_slots)
        vt += struct.pack("<H", table_off - start_len)
        for fid in range(n_slots):
            vt += struct.pack("<H",
                              table_off - slots[fid] if fid in slots else 0)
        self._prep(2, 0)
        self._prepend(bytes(vt))
        vtable_off = len(self._buf)
        # patch the soffset (table -> vtable, signed, positive here)
        pos = len(self._buf) - table_off
        self._buf[pos : pos + 4] = struct.pack("<i", vtable_off - table_off)
        return table_off

    def finish(self, root: int) -> bytes:
        # pad BEFORE the root uoffset so it stays the first 4 bytes and
        # the total length is 8-aligned
        self._prep(8, 4)
        self.uoffset(root)
        return bytes(self._buf)


class FBTable:
    """Read-side accessor: buf + absolute table position."""

    def __init__(self, buf: bytes, pos: int) -> None:
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf: bytes, base: int = 0) -> "FBTable":
        (off,) = struct.unpack_from("<I", buf, base)
        return cls(buf, base + off)

    def _field_pos(self, fid: int) -> Optional[int]:
        (soff,) = struct.unpack_from("<i", self.buf, self.pos)
        vt = self.pos - soff
        (vsize,) = struct.unpack_from("<H", self.buf, vt)
        slot = 4 + 2 * fid
        if slot + 2 > vsize:
            return None
        (off,) = struct.unpack_from("<H", self.buf, vt + slot)
        return self.pos + off if off else None

    def scalar(self, fid: int, fmt: str, default=0):
        pos = self._field_pos(fid)
        if pos is None:
            return default
        return struct.unpack_from("<" + fmt, self.buf, pos)[0]

    def _indirect(self, pos: int) -> int:
        (off,) = struct.unpack_from("<I", self.buf, pos)
        return pos + off

    def table(self, fid: int) -> Optional["FBTable"]:
        pos = self._field_pos(fid)
        if pos is None:
            return None
        return FBTable(self.buf, self._indirect(pos))

    def string(self, fid: int) -> Optional[str]:
        pos = self._field_pos(fid)
        if pos is None:
            return None
        vpos = self._indirect(pos)
        (n,) = struct.unpack_from("<I", self.buf, vpos)
        return self.buf[vpos + 4 : vpos + 4 + n].decode()

    def vector(self, fid: int) -> Optional[Tuple[int, int]]:
        """Returns (element_start, length)."""
        pos = self._field_pos(fid)
        if pos is None:
            return None
        vpos = self._indirect(pos)
        (n,) = struct.unpack_from("<I", self.buf, vpos)
        return vpos + 4, n

    def table_vec(self, fid: int) -> List["FBTable"]:
        vec = self.vector(fid)
        if vec is None:
            return []
        start, n = vec
        return [
            FBTable(self.buf, self._indirect(start + 4 * i))
            for i in range(n)
        ]


# --------------------------------------------------------------------------
# Arrow IPC file (Feather V2): schema + one record batch + file footer


def _field_table(b: FBBuilder, name: str, type_type: int,
                 type_off: int, children: Sequence[int] = ()) -> int:
    name_off = b.string(name)
    fields: Dict[int, Tuple[str, Any]] = {
        0: ("o", name_off),
        1: ("b", 1),            # nullable
        2: ("B", type_type),    # type union tag
        3: ("o", type_off),
    }
    if children:
        fields[5] = ("o", b.offset_vec(list(children)))
    return b.table(fields)


def _type_off(b: FBBuilder, col: "Column") -> Tuple[int, int, List[int]]:
    """(type_type, type_offset, child_field_offsets) for a column."""
    kind = col.kind
    if kind == "int":
        return TYPE_INT, b.table({0: ("i", col.bits), 1: ("b", int(col.signed))}), []
    if kind == "float32":
        return TYPE_FLOATING_POINT, b.table({0: ("h", FP_SINGLE)}), []
    if kind == "fsb16":
        return TYPE_FIXED_SIZE_BINARY, b.table({0: ("i", 16)}), []
    if kind == "large_binary":
        return TYPE_LARGE_BINARY, b.table({}), []
    if kind == "utf8":
        return TYPE_UTF8, b.table({}), []
    if kind == "large_list_u64":
        child_type = b.table({0: ("i", 64), 1: ("b", 0)})
        child = _field_table(b, "item", TYPE_INT, child_type)
        return TYPE_LARGE_LIST, b.table({}), [child]
    if kind == "large_list_i16":
        child_type = b.table({0: ("i", 16), 1: ("b", 1)})
        child = _field_table(b, "item", TYPE_INT, child_type)
        return TYPE_LARGE_LIST, b.table({}), [child]
    raise ValueError(kind)


class Column:
    """One Arrow column: a kind tag plus its buffers/child layout."""

    def __init__(self, name: str, kind: str, values) -> None:
        self.name = name
        self.kind = kind
        self.values = values
        self.bits = {"int16": 16, "uint16": 16, "uint32": 32,
                     "uint64": 64}.get(kind)
        self.signed = kind in ("int16",)
        if self.bits is not None:
            self.kind = "int"

    def n_rows(self) -> int:
        return len(self.values)

    def buffers(self) -> List[Tuple[bytes, int]]:
        """[(buffer_bytes, n_child_rows_consumed)] in Arrow layout order;
        every column leads with an empty validity bitmap (null_count 0)."""
        v = self.values
        if self.kind == "int":
            dt = {16: np.int16 if self.signed else np.uint16,
                  32: np.uint32, 64: np.uint64}[self.bits]
            return [(b"", 0), (np.asarray(v, dt).tobytes(), 0)]
        if self.kind == "float32":
            return [(b"", 0), (np.asarray(v, np.float32).tobytes(), 0)]
        if self.kind == "fsb16":
            return [(b"", 0), (b"".join(v), 0)]
        if self.kind in ("large_binary", "utf8"):
            offs = np.zeros(len(v) + 1, np.int64)
            datas = []
            for i, item in enumerate(v):
                item = item.encode() if isinstance(item, str) else item
                datas.append(item)
                offs[i + 1] = offs[i] + len(item)
            off_fmt = offs.astype(
                np.int64 if self.kind == "large_binary" else np.int32
            )
            return [(b"", 0), (off_fmt.tobytes(), 0),
                    (b"".join(datas), 0)]
        if self.kind in ("large_list_u64", "large_list_i16"):
            offs = np.zeros(len(v) + 1, np.int64)
            flat = []
            for i, item in enumerate(v):
                offs[i + 1] = offs[i] + len(item)
                flat.append(np.asarray(
                    item,
                    np.uint64 if self.kind == "large_list_u64" else np.int16,
                ))
            child = (np.concatenate(flat).tobytes() if flat else b"")
            # parent validity + offsets, child validity + data
            return [(b"", 0), (offs.tobytes(), 0), (b"", 1), (child, 0)]
        raise ValueError(self.kind)

    def field_nodes(self) -> List[Tuple[int, int]]:
        """(length, null_count) per node (parent first, then children)."""
        if self.kind in ("large_list_u64", "large_list_i16"):
            total = sum(len(x) for x in self.values)
            return [(len(self.values), 0), (total, 0)]
        return [(len(self.values), 0)]


def _schema_bytes(cols: Sequence[Column]) -> bytes:
    b = FBBuilder()
    field_offs = []
    for col in cols:
        tt, toff, children = _type_off(b, col)
        field_offs.append(_field_table(b, col.name, tt, toff, children))
    schema = b.table({0: ("h", 0), 1: ("o", b.offset_vec(field_offs))})
    message = b.table({
        0: ("h", 4),            # MetadataVersion V5
        1: ("B", MSG_SCHEMA),
        2: ("o", schema),
        3: ("q", 0),
    })
    return b.finish(message)


def _batch_bytes(cols: Sequence[Column]) -> Tuple[bytes, bytes]:
    """(record-batch message flatbuffer, body bytes)."""
    body = bytearray()
    buf_meta = []
    nodes = []
    for col in cols:
        nodes.extend(col.field_nodes())
        for data, _ in col.buffers():
            off = len(body)
            buf_meta.append((off, len(data)))
            body += data
            while len(body) % 8:
                body += b"\0"
    b = FBBuilder()
    bufs = b"".join(struct.pack("<qq", off, ln) for off, ln in buf_meta)
    nodes_b = b"".join(struct.pack("<qq", ln, nc) for ln, nc in nodes)
    buf_vec = b.struct_vec(bufs, len(buf_meta), 8)
    node_vec = b.struct_vec(nodes_b, len(nodes), 8)
    batch = b.table({
        0: ("q", cols[0].n_rows()),
        1: ("o", node_vec),
        2: ("o", buf_vec),
    })
    message = b.table({
        0: ("h", 4),
        1: ("B", MSG_RECORD_BATCH),
        2: ("o", batch),
        3: ("q", len(body)),
    })
    return b.finish(message), bytes(body)


def _encapsulate(meta: bytes) -> bytes:
    pad = (8 - (len(meta) + 8) % 8) % 8
    return (b"\xff\xff\xff\xff" + struct.pack("<I", len(meta) + pad)
            + meta + b"\0" * pad)


def write_arrow_file(cols: Sequence[Column]) -> bytes:
    """A complete Arrow IPC file: magic, schema, one record batch,
    file footer, footer length, magic."""
    out = bytearray(ARROW_MAGIC + b"\0\0")
    schema_msg = _encapsulate(_schema_bytes(cols))
    out += schema_msg
    batch_meta, body = _batch_bytes(cols)
    batch_off = len(out)
    batch_msg = _encapsulate(batch_meta)
    out += batch_msg + body
    out += b"\xff\xff\xff\xff\x00\x00\x00\x00"  # EOS
    # file footer: re-emit the schema + the record-batch block
    b = FBBuilder()
    field_offs = []
    for col in cols:
        tt, toff, children = _type_off(b, col)
        field_offs.append(_field_table(b, col.name, tt, toff, children))
    schema = b.table({0: ("h", 0), 1: ("o", b.offset_vec(field_offs))})
    block = struct.pack("<qiiq", batch_off, len(batch_msg), 0, len(body))
    blocks = b.struct_vec(block, 1, 8)
    dicts = b.struct_vec(b"", 0, 8)
    footer = b.table({
        0: ("h", 4), 1: ("o", schema), 2: ("o", dicts), 3: ("o", blocks),
    })
    footer_bytes = b.finish(footer)
    out += footer_bytes
    out += struct.pack("<i", len(footer_bytes))
    out += ARROW_MAGIC
    return bytes(out)


# ---- Arrow IPC reading ----------------------------------------------------


def _parse_field(f: FBTable) -> Dict[str, Any]:
    name = f.string(0)
    ttype = f.scalar(2, "B")
    t = f.table(3)
    info: Dict[str, Any] = {"name": name, "type": ttype}
    if ttype == TYPE_INT and t is not None:
        info["bits"] = t.scalar(0, "i")
        info["signed"] = bool(t.scalar(1, "b"))
    if ttype == TYPE_FIXED_SIZE_BINARY and t is not None:
        info["byte_width"] = t.scalar(0, "i")
    children = f.table_vec(5)
    info["children"] = [_parse_field(c) for c in children]
    return info


def read_arrow_file(data: bytes) -> Dict[str, Any]:
    """Parse one embedded Arrow IPC file -> {column_name: numpy/list}.

    Understands the layouts write_arrow_file produces (ints, float32,
    fixed_size_binary(16), utf8/large_binary, large_list<u64/i16>) and
    skips unknown columns gracefully."""
    if data[:6] != ARROW_MAGIC:
        raise ValueError("not an Arrow IPC file")
    pos = 8
    fields = None
    out: Dict[str, Any] = {}
    while pos + 8 <= len(data):
        cont, meta_len = struct.unpack_from("<Ii", data, pos)
        if cont != 0xFFFFFFFF:
            break
        pos += 8
        if meta_len == 0:
            break
        msg = FBTable.root(data, pos)
        header_type = msg.scalar(1, "B")
        body_len = msg.scalar(3, "q")
        header = msg.table(2)
        pos += meta_len
        if header_type == MSG_SCHEMA and header is not None:
            fields = [_parse_field(f) for f in header.table_vec(1)]
        elif header_type == MSG_RECORD_BATCH and header is not None:
            if fields is None:
                raise ValueError("record batch before schema")
            out = _decode_batch(data, pos, header, fields, out)
        pos += body_len
    return out


def _decode_batch(data, body_pos, batch: FBTable, fields, out):
    n_rows = batch.scalar(0, "q")
    bstart, bn = batch.vector(2) or (0, 0)
    buffers = [struct.unpack_from("<qq", data, bstart + 16 * i)
               for i in range(bn)]
    bi = 0

    def next_buf():
        nonlocal bi
        off, ln = buffers[bi]
        bi += 1
        return data[body_pos + off : body_pos + off + ln]

    for f in fields:
        name, ttype = f["name"], f["type"]
        next_buf()  # validity (null_count 0 throughout)
        if ttype == TYPE_INT:
            dt = {(16, True): np.int16, (16, False): np.uint16,
                  (32, True): np.int32, (32, False): np.uint32,
                  (64, True): np.int64, (64, False): np.uint64}[
                      (f["bits"], f["signed"])]
            col = np.frombuffer(next_buf(), dt)[:n_rows]
        elif ttype == TYPE_FLOATING_POINT:
            col = np.frombuffer(next_buf(), np.float32)[:n_rows]
        elif ttype == TYPE_FIXED_SIZE_BINARY:
            w = f["byte_width"]
            raw = next_buf()
            col = [raw[i * w : (i + 1) * w] for i in range(n_rows)]
        elif ttype in (TYPE_LARGE_BINARY, TYPE_UTF8):
            offs = np.frombuffer(
                next_buf(),
                np.int64 if ttype == TYPE_LARGE_BINARY else np.int32,
            )[: n_rows + 1]
            raw = next_buf()
            col = [bytes(raw[offs[i] : offs[i + 1]]) for i in range(n_rows)]
            if ttype == TYPE_UTF8:
                col = [c.decode() for c in col]
        elif ttype == TYPE_LARGE_LIST:
            offs = np.frombuffer(next_buf(), np.int64)[: n_rows + 1]
            child = f["children"][0]
            next_buf()  # child validity
            cdt = {(64, False): np.uint64, (16, True): np.int16}[
                (child["bits"], child["signed"])]
            flat = np.frombuffer(next_buf(), cdt)
            col = [flat[offs[i] : offs[i + 1]] for i in range(n_rows)]
        else:
            raise ValueError(f"unsupported column type {ttype} ({name})")
        out[name] = col
    return out


# --------------------------------------------------------------------------
# the pod5 container


def write_pod5(
    path: str,
    reads: Sequence[Tuple[bytes, np.ndarray]],
    sample_rate: int = 4000,
    calibration: Tuple[float, float] = (0.0, 0.17089844),
    compress: bool = True,
    chunk_samples: int = 102_400,
) -> None:
    """Write a .pod5 with the given (read_id_16B, int16_signal) reads.

    ``calibration`` is (offset, scale): pA = scale * (adc + offset) —
    pod5's calibration convention. Signal chunks of ``chunk_samples``
    per signal-table row, vbz-compressed unless ``compress`` is False.
    """
    from deepmod_tpu_torch.io.vbz import compress as vbz_compress

    sig_ids: List[bytes] = []
    sig_rows: List[Any] = []
    samples: List[int] = []
    row_index: List[List[int]] = []
    for rid, signal in reads:
        if len(rid) != 16:
            raise ValueError("read_id must be 16 bytes (UUID)")
        signal = np.asarray(signal, np.int16)
        rows = []
        for lo in range(0, max(len(signal), 1), chunk_samples):
            chunk = signal[lo : lo + chunk_samples]
            rows.append(len(sig_ids))
            sig_ids.append(rid)
            samples.append(len(chunk))
            sig_rows.append(
                vbz_compress(chunk) if compress else chunk
            )
        row_index.append(rows)

    sig_cols = [
        Column("read_id", "fsb16", sig_ids),
        Column("signal",
               "large_binary" if compress else "large_list_i16", sig_rows),
        Column("samples", "uint32", samples),
    ]
    reads_cols = [
        Column("read_id", "fsb16", [rid for rid, _ in reads]),
        Column("signal", "large_list_u64", row_index),
        Column("read_number", "uint32", list(range(len(reads)))),
        Column("start", "uint64", [0] * len(reads)),
        Column("median_before", "float32", [0.0] * len(reads)),
        Column("calibration_offset", "float32",
               [calibration[0]] * len(reads)),
        Column("calibration_scale", "float32",
               [calibration[1]] * len(reads)),
        Column("run_info", "int16", [0] * len(reads)),
    ]
    run_cols = [
        Column("acquisition_id", "utf8", ["synthetic"]),
        Column("sample_rate", "uint16", [sample_rate]),
    ]

    marker = uuid.uuid4().bytes
    out = bytearray(POD5_SIGNATURE + marker)
    embedded = []
    for content, cols in ((CONTENT_SIGNAL, sig_cols),
                          (CONTENT_READS, reads_cols),
                          (CONTENT_RUN_INFO, run_cols)):
        blob = write_arrow_file(cols)
        while len(out) % 8:
            out += b"\0"
        embedded.append((len(out), len(blob), content))
        out += blob
        out += marker

    b = FBBuilder()
    file_offs = []
    for off, length, content in embedded:
        file_offs.append(b.table({
            0: ("q", off), 1: ("q", length),
            2: ("h", FORMAT_FEATHER_V2), 3: ("h", content),
        }))
    footer = b.table({
        0: ("o", b.string(str(uuid.UUID(bytes=marker)))),
        1: ("o", b.string("deepmod_tpu_torch")),
        2: ("o", b.string("0.1")),
        3: ("o", b.offset_vec(file_offs)),
    })
    footer_bytes = b.finish(footer)
    while len(out) % 8:
        out += b"\0"
    out += footer_bytes
    out += struct.pack("<q", len(footer_bytes))
    out += marker
    out += POD5_SIGNATURE
    with open(path, "wb") as fh:
        fh.write(out)


class Pod5Read:
    __slots__ = ("read_id", "signal", "sample_rate", "calibration")

    def __init__(self, read_id, signal, sample_rate, calibration):
        self.read_id = read_id
        self.signal = signal
        self.sample_rate = sample_rate
        self.calibration = calibration


def read_pod5(path: str) -> List[Pod5Read]:
    """Parse a .pod5 -> reads with raw int16 signal + calibration.

    Signal columns decode through io.vbz when stored as large_binary."""
    from deepmod_tpu_torch.io.vbz import decompress as vbz_decompress

    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != POD5_SIGNATURE or data[-8:] != POD5_SIGNATURE:
        raise ValueError("not a pod5 file (signature mismatch)")
    (footer_len,) = struct.unpack_from("<q", data, len(data) - 32)
    footer_start = len(data) - 32 - footer_len
    footer = FBTable.root(data, footer_start)
    tables: Dict[int, Dict[str, Any]] = {}
    for ef in footer.table_vec(3):
        off = ef.scalar(0, "q")
        length = ef.scalar(1, "q")
        content = ef.scalar(3, "h")
        tables[content] = read_arrow_file(data[off : off + length])

    sig = tables[CONTENT_SIGNAL]
    rds = tables[CONTENT_READS]
    run = tables.get(CONTENT_RUN_INFO, {})
    rate = int(run["sample_rate"][0]) if "sample_rate" in run else 4000

    out = []
    for i, rid in enumerate(rds["read_id"]):
        chunks = []
        for row in rds["signal"][i]:
            item = sig["signal"][int(row)]
            if isinstance(item, (bytes, bytearray)):
                n = int(sig["samples"][int(row)])
                chunks.append(vbz_decompress(bytes(item), n))
            else:
                chunks.append(np.asarray(item, np.int16))
        signal = (np.concatenate(chunks) if chunks
                  else np.empty(0, np.int16))
        cal = (float(rds["calibration_offset"][i]),
               float(rds["calibration_scale"][i]))
        out.append(Pod5Read(bytes(rid), signal, rate, cal))
    return out


def is_pod5(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            return fh.read(8) == POD5_SIGNATURE
    except OSError:
        return False
