"""Write a TF V2 checkpoint (a tensor bundle) from numpy arrays, without
TensorFlow.

For tests and ``chip_smoke.py``: the card's machine has no TensorFlow, and
the reference's model files are TF1 checkpoints. ``write_bundle`` writes
``<prefix>.index`` and ``<prefix>.data-00000-of-00001`` in the layout that
``deepmod_tpu_torch/models/tf_bundle.py`` describes, as TF's
``BundleWriter`` does: one shard, entries in byte order of their keys
(the header under the empty key first), uncompressed blocks with a
restart every 16 keys, an empty metaindex block. TensorFlow's own reader
reads what it writes (``tests/test_torch_tf_import.py``).
``write_reference_bilstm`` and ``write_reference_cluster`` write a model
under the reference's variable names, with the Adam slots, beta powers
and ``global_step`` that its trainers' Savers also store. No entry point
of the port imports this module.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

from deepmod_tpu_torch.models.tf_import import (
    RNN_BIAS,
    RNN_KERNEL,
    params_to_numpy,
)
from deepmod_tpu_torch.models.tf_bundle import (
    DTYPE_ENUM,
    FOOTER_BYTES,
    TABLE_MAGIC,
    masked_crc32c,
)

RESTART_INTERVAL = 16  # LevelDB's default, which TF's table writer keeps


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varint_field(field: int, n: int) -> bytes:
    """A varint field, left out at 0 as proto3 does."""
    return _varint(field << 3) + _varint(n) if n else b""


def _bytes_field(field: int, b: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(b)) + b


def _block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """A table block's contents: prefix-compressed entries, restarts."""
    out = bytearray()
    restarts: List[int] = []
    last = b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % RESTART_INTERVAL == 0:
            restarts.append(len(out))
        else:
            while (shared < min(len(last), len(key))
                   and last[shared] == key[shared]):
                shared += 1
        out += (_varint(shared) + _varint(len(key) - shared)
                + _varint(len(value)) + key[shared:] + value)
        last = key
    restarts = restarts or [0]
    out += b"".join(struct.pack("<I", r) for r in restarts)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _append_block(buf: bytearray, contents: bytes) -> bytes:
    """Append a block and its trailer; returns its encoded handle."""
    handle = _varint(len(buf)) + _varint(len(contents))
    trailer = b"\x00"  # no compression
    buf += contents + trailer
    buf += struct.pack("<I", masked_crc32c(contents + trailer))
    return handle


def _entry(arr: np.ndarray, dtype: str, offset: int, raw: bytes) -> bytes:
    shape = b"".join(_bytes_field(2, _varint_field(1, int(d)))
                     for d in arr.shape)
    return (_varint_field(1, DTYPE_ENUM[dtype]) + _bytes_field(2, shape)
            + _varint_field(4, offset) + _varint_field(5, len(raw))
            + _varint(6 << 3 | 5) + struct.pack("<I", masked_crc32c(raw)))


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray],
                 bfloat16: Iterable[str] = ()) -> None:
    """Write ``tensors`` as the V2 checkpoint ``prefix``. Each array keeps
    its numpy dtype; the names in ``bfloat16`` are stored as bfloat16 (the
    top 16 bits of their float32 values: exact for values that bf16
    holds)."""
    bfloat16 = set(bfloat16)
    data = bytearray()
    entries = []
    for name in sorted(tensors, key=str.encode):
        arr = np.asarray(tensors[name])
        if name in bfloat16:
            dtype = "bfloat16"
            bits = np.ascontiguousarray(arr, np.float32).view(np.uint32) >> 16
            raw = bits.astype("<u2").tobytes()
        else:
            dtype = arr.dtype.name
            raw = np.ascontiguousarray(arr).astype(
                arr.dtype.newbyteorder("<")).tobytes()
        entries.append((name.encode(), _entry(arr, dtype, len(data), raw)))
        data += raw
    with open(f"{prefix}.data-00000-of-00001", "wb") as fh:
        fh.write(data)
    # num_shards 1, little-endian (0, left out), version {producer: 1}
    header = _varint_field(1, 1) + _bytes_field(3, _varint_field(1, 1))
    write_table(prefix + ".index", [(b"", header)] + entries)


def write_table(path: str, entries: List[Tuple[bytes, bytes]]) -> None:
    """A LevelDB-format table of ``entries`` (in key order) in one data
    block, with an empty metaindex block."""
    index = bytearray()
    data_handle = _append_block(index, _block(entries))
    meta_handle = _append_block(index, _block([]))
    # the index block's key for the one data block: its last key
    index_handle = _append_block(index, _block([(entries[-1][0],
                                                 data_handle)]))
    footer = meta_handle + index_handle
    footer += b"\x00" * (FOOTER_BYTES - 8 - len(footer))
    index += footer + struct.pack("<Q", TABLE_MAGIC)
    with open(path, "wb") as fh:
        fh.write(index)


def with_adam_slots(tensors: Dict[str, np.ndarray],
                    step: int = 1) -> Dict[str, np.ndarray]:
    """``tensors`` plus what a TF1 ``AdamOptimizer`` and its global step
    add to a checkpoint: ``<name>/Adam`` and ``<name>/Adam_1`` (zeros
    here), ``beta1_power``, ``beta2_power`` and ``global_step`` (int64)."""
    out = dict(tensors)
    for name, arr in tensors.items():
        out[name + "/Adam"] = np.zeros_like(arr)
        out[name + "/Adam_1"] = np.zeros_like(arr)
    out["beta1_power"] = np.float32(0.9 ** (step + 1))
    out["beta2_power"] = np.float32(0.999 ** (step + 1))
    out["global_step"] = np.int64(step)
    return out


def write_reference_bilstm(prefix: str, params, step: int = 1) -> None:
    """A BiLSTM params tree (numpy or torch) as the reference's TF1
    checkpoint (myMultiBiRNN.py:21-91 names, Adam slots included)."""
    tree = params_to_numpy(params)
    tensors = {"Variable": tree["out_w"], "Variable_1": tree["out_b"]}
    for d in ("fw", "bw"):
        for layer, lp in enumerate(tree[d]):
            tensors[RNN_KERNEL.format(d=d, l=layer)] = lp["kernel"]
            tensors[RNN_BIAS.format(d=d, l=layer)] = lp["bias"]
    write_bundle(prefix, with_adam_slots(tensors, step))


def write_reference_cluster(prefix: str, params: Dict[str, np.ndarray],
                            step: int = 1) -> None:
    """Cluster-MLP params (``W_1`` ... ``b_O``) as the reference's TF1
    checkpoint, Adam slots included."""
    write_bundle(prefix, with_adam_slots(
        {k: np.asarray(v, np.float32) for k, v in params.items()}, step))
