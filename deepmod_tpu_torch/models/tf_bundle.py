"""TensorFlow's V2 checkpoint format, read with numpy and the standard
library alone.

The reference's models are TF1 checkpoints written by ``tf.train.Saver``:
``<prefix>.index`` plus ``<prefix>.data-<shard>-of-<shards>`` (TF's
``tensorflow/core/util/tensor_bundle``). The JAX package reads them
through TF's ``py_checkpoint_reader.NewCheckpointReader``;
``CheckpointReader`` here offers the three calls it makes
(``get_variable_to_shape_map``, ``get_variable_to_dtype_map``,
``get_tensor``) without TensorFlow, which the card's machine does not have.

The format, as TF writes and reads it:

- ``.index`` is an SSTable in LevelDB's layout. Its last 48 bytes are the
  footer: the metaindex and index block handles (varint offset and size
  each), zero padding, and the magic ``0xdb4775248b80fb57`` (fixed64).
  Each block is followed by a 5-byte trailer: a compression byte (0: none)
  and the masked crc32c of the block and that byte. A block holds entries
  ``shared, non_shared, value_length`` (varints), the key's unshared
  suffix and the value, then a restart array of fixed32 offsets and its
  length. The index block maps a separator key to each data block's
  handle.
- The entry under the empty key is a ``BundleHeaderProto``
  (1: num_shards, 2: endianness, 3: version). Every other key is a
  variable's name and its value a ``BundleEntryProto``: 1 dtype, 2 shape
  (a ``TensorShapeProto``: 2 dims, each with 1 size), 3 shard_id,
  4 offset, 5 size, 6 crc32c (fixed32, masked), 7 slices.
- A tensor is ``size`` raw little-endian bytes at ``offset`` of its
  shard's ``.data`` file; its masked crc32c is checked on every read, as
  TF's reader does.

Not read, each with an error that names the cause: V1 checkpoints (no
``.index``; TF's reader takes them), compressed blocks, big-endian
bundles, partitioned variables (entries with slices) and string tensors.
Proto fields this reader does not know are skipped by their wire type.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48  # two BlockHandles padded to 2 x 20 bytes, then the magic
BLOCK_TRAILER_BYTES = 5

# TF's DataType enum (types.proto) -> (name, little-endian numpy dtype);
# bfloat16 is stored as its 16 bits and widened exactly to float32
DTYPES: Dict[int, Tuple[str, str]] = {
    1: ("float32", "<f4"),
    2: ("float64", "<f8"),
    3: ("int32", "<i4"),
    4: ("uint8", "u1"),
    5: ("int16", "<i2"),
    6: ("int8", "i1"),
    9: ("int64", "<i8"),
    10: ("bool", "?"),
    14: ("bfloat16", "<u2"),
    17: ("uint16", "<u2"),
    19: ("float16", "<f2"),
    22: ("uint32", "<u4"),
    23: ("uint64", "<u8"),
}
DTYPE_ENUM = {name: enum for enum, (name, _) in DTYPES.items()}


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of LevelDB tables and TF bundles."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """LevelDB's mask of a stored crc: rotate right by 15, add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the base-128 varint at ``pos``."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def proto_fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a serialized proto: an int
    for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = read_varint(buf, pos)
            yield field, value
            continue
        if wire == 2:
            n, pos = read_varint(buf, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
        else:
            raise ValueError(f"proto wire type {wire} (field {field}) is not "
                             "read")
        if pos + n > len(buf):
            raise ValueError("truncated proto")
        raw = bytes(buf[pos : pos + n])
        pos += n
        yield field, raw if wire == 2 else int.from_bytes(raw, "little")


@dataclasses.dataclass(frozen=True)
class BundleEntry:
    dtype: int
    shape: Tuple[int, ...]
    shard: int
    offset: int
    size: int
    crc: int


def _parse_entry(name: str, value: bytes) -> BundleEntry:
    fields = {"dtype": 0, "shape": (), "shard": 0, "offset": 0, "size": 0,
              "crc": 0}
    for field, v in proto_fields(value):
        if field == 1:
            fields["dtype"] = v
        elif field == 2:
            fields["shape"] = tuple(
                dict(proto_fields(dim)).get(1, 0)
                for f, dim in proto_fields(v) if f == 2)
        elif field == 3:
            fields["shard"] = v
        elif field == 4:
            fields["offset"] = v
        elif field == 5:
            fields["size"] = v
        elif field == 6:
            fields["crc"] = v
        elif field == 7:
            raise ValueError(
                f"{name!r} is a partitioned variable (an entry with slices); "
                "partitioned variables are not read")
    return BundleEntry(**fields)


def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    """The contents of the table block at (offset, size), trailer checked."""
    end = offset + size + BLOCK_TRAILER_BYTES
    if end > len(data):
        raise ValueError(f"{what}: block at {offset}+{size} runs past the "
                         "end of the file")
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"{what}: block compression type {kind} "
                         "(only 0, uncompressed, is read)")
    stored = struct.unpack_from("<I", data, offset + size + 1)[0]
    if masked_crc32c(data[offset : offset + size + 1]) != stored:
        raise ValueError(f"{what}: block checksum (crc32c) mismatch")
    return data[offset : offset + size]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of each entry of a block, keys prefix-decompressed."""
    if len(block) < 4:
        raise ValueError("table block shorter than its restart count")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 * (n_restarts + 1)
    if limit < 0:
        raise ValueError("table block's restart array overruns the block")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = read_varint(block, pos)
        non_shared, pos = read_varint(block, pos)
        n_value, pos = read_varint(block, pos)
        if shared > len(key) or pos + non_shared + n_value > limit:
            raise ValueError("corrupt table block entry")
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        yield key, block[pos : pos + n_value]
        pos += n_value


def _handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = read_varint(buf, pos)
    size, pos = read_varint(buf, pos)
    return offset, size, pos


def read_table(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Every (key, value) of a LevelDB-format table file, in key order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: shorter than a table footer")
    footer = data[-FOOTER_BYTES:]
    magic = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0]
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a table (footer magic {magic:#x})")
    _, _, pos = _handle(footer)  # the metaindex block: TF writes it empty
    index_offset, index_size, _ = _handle(footer, pos)
    index = _block(data, index_offset, index_size, f"{path} index")
    for _, handle in _block_entries(index):
        offset, size, _ = _handle(handle)
        yield from _block_entries(_block(data, offset, size, path))


class CheckpointReader:
    """TF's ``NewCheckpointReader`` for a V2 checkpoint ``prefix``.

    Shapes and dtypes come from ``.index`` alone, so a checkpoint whose
    ``.data`` files were stripped still gives them; ``get_tensor`` raises
    ``FileNotFoundError`` naming the missing shard. Dtypes are TF's names
    (``"float32"``, ``"bfloat16"``, ...); a bfloat16 tensor comes back
    widened exactly to float32, since numpy has no bfloat16.
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        if not os.path.exists(index):
            if os.path.isfile(prefix):
                raise ValueError(
                    f"{prefix}: a TF V1 checkpoint (one file, no .index); "
                    "only V2 checkpoints are read")
            raise FileNotFoundError(f"{index}: no TF checkpoint at {prefix}")
        header = None
        self._entries: Dict[str, BundleEntry] = {}
        for key, value in read_table(index):
            if key == b"":
                header = dict(proto_fields(value))
            else:
                name = key.decode()
                self._entries[name] = _parse_entry(name, value)
        if header is None:
            raise ValueError(f"{index}: no bundle header entry")
        if header.get(2, 0) != 0:
            raise ValueError(f"{index}: a big-endian bundle is not read")
        self.num_shards = header.get(1, 1)

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(e.shape) for k, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> Dict[str, str]:
        return {k: DTYPES.get(e.dtype, (f"DataType {e.dtype}",))[0]
                for k, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self._entries:
            raise KeyError(f"{name!r} is not in the checkpoint {self.prefix}")
        e = self._entries[name]
        if e.dtype not in DTYPES:
            raise ValueError(f"{name!r}: TF DataType {e.dtype} is not read")
        tf_name, np_dtype = DTYPES[e.dtype]
        count = int(np.prod(e.shape, dtype=np.int64))
        if count * np.dtype(np_dtype).itemsize != e.size:
            raise ValueError(f"{name!r}: {e.size} bytes for shape {e.shape} "
                             f"of {tf_name}")
        path = f"{self.prefix}.data-{e.shard:05d}-of-{self.num_shards:05d}"
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: data shard {e.shard} of {self.num_shards} of the "
                f"checkpoint {self.prefix} is missing")
        with open(path, "rb") as fh:
            fh.seek(e.offset)
            raw = fh.read(e.size)
        if len(raw) != e.size:
            raise ValueError(f"{name!r}: {path} ends inside the tensor")
        if masked_crc32c(raw) != e.crc:
            raise ValueError(f"{name!r}: crc32c mismatch in {path}")
        out = np.frombuffer(raw, np_dtype).reshape(e.shape)
        if tf_name == "bfloat16":
            return (out.astype(np.uint32) << 16).view(np.float32)
        return out.astype(out.dtype.newbyteorder("="))
