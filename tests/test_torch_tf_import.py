"""The reference's TF1 checkpoints in the port, read without TensorFlow.

- The port's reader (``models/tf_bundle.py``) reads what the port's writer
  (``testing/tf_bundle.py``) writes, for every dtype it reads, bit for
  bit, and refuses what it does not read with an error naming the cause.
- Against TensorFlow itself (skipped where TF is absent): checkpoints
  written by ``tf.compat.v1.train.Saver`` (the full-width BiLSTM of
  tests/test_tf_checkpoint_roundtrip.py with its Adam slots and global
  step, and the bundled cluster model) give the port's reader the names,
  shapes, dtypes and bits that TF's reader gives, and the port's loaders
  the params of the JAX package's TF-based loaders, bit for bit; TF reads
  the port's writer's output. TF runs in a subprocess, apart from torch.
- Through the model: the port's logits from a TF prefix within 2e-5
  (fp32, absolute) of the JAX package's ``bilstm_logits``.
- Through the commands: ``detect --modfile <prefix>`` and
  ``clusterpred --model <prefix>`` give the outputs of the ``.npz`` runs,
  byte for byte.
"""

import contextlib
import glob
import io
import json
import os
import shutil
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmod_tpu.models import bilstm as jb
from deepmod_tpu_torch import cli as torch_cli
from deepmod_tpu_torch.models import bilstm as tb
from deepmod_tpu_torch.models import tf_bundle as tfb
from deepmod_tpu_torch.models import tf_import as tt
from deepmod_tpu_torch.testing import tf_bundle as writer
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "cluster_weights.npz")


def _every_dtype():
    rng = np.random.default_rng(3)
    arrays = {
        "float32": rng.standard_normal((3, 4)).astype(np.float32),
        "float64": rng.standard_normal(5),
        "int32": rng.integers(-2**31, 2**31 - 1, 6, dtype=np.int32),
        "uint8": rng.integers(0, 255, 7, dtype=np.uint8),
        "int16": rng.integers(-2**15, 2**15 - 1, 3, dtype=np.int16),
        "int8": rng.integers(-128, 127, 4, dtype=np.int8),
        "int64": rng.integers(-2**62, 2**62, (2, 2), dtype=np.int64),
        "bool": rng.random(9) < 0.5,
        "uint16": rng.integers(0, 2**16 - 1, 3, dtype=np.uint16),
        "float16": rng.standard_normal(4).astype(np.float16),
        "uint32": rng.integers(0, 2**32 - 1, 3, dtype=np.uint32),
        "uint64": rng.integers(0, 2**63, 3, dtype=np.uint64),
        # bf16-representable float32 values: the low 16 bits clear
        "bfloat16": (rng.standard_normal(6).astype(np.float32).view(np.uint32)
                     & 0xFFFF0000).view(np.float32),
    }
    assert sorted(arrays) == sorted(name for name, _ in tfb.DTYPES.values())
    tensors = {f"x/{k}": v for k, v in arrays.items()}
    tensors["scalar"] = np.float32(2.5)
    tensors["empty"] = np.zeros((0, 3), np.float32)
    # more keys than a restart interval, sharing long prefixes
    for i in range(20):
        tensors[f"bidirectional_rnn/fw/cell_{i}/kernel"] = np.full(
            (2, i % 3 + 1), i, np.float32)
    return tensors


def _assert_reads_back(reader, tensors, bf16=("x/bfloat16",)):
    assert reader.get_variable_to_shape_map() == {
        k: list(np.shape(v)) for k, v in tensors.items()}
    dtypes = reader.get_variable_to_dtype_map()
    for name, want in tensors.items():
        want = np.asarray(want)
        got = reader.get_tensor(name)
        assert dtypes[name] == ("bfloat16" if name in bf16
                                else want.dtype.name), name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def test_round_trip_every_dtype(tmp_path):
    tensors = _every_dtype()
    prefix = str(tmp_path / "ck")
    writer.write_bundle(prefix, tensors, bfloat16=["x/bfloat16"])
    _assert_reads_back(tfb.CheckpointReader(prefix), tensors)


def test_crc32c_check_value():
    assert tfb.crc32c(b"123456789") == 0xE3069283  # CRC-32C's check value
    assert tfb.crc32c(b"") == 0


def _data_block(index: bytearray):
    """(offset, size) of the one data block of a written .index."""
    footer = bytes(index[-tfb.FOOTER_BYTES:])
    _, _, pos = tfb._handle(footer)
    offset, size, _ = tfb._handle(footer, pos)
    ((_, handle),) = tfb._block_entries(bytes(index[offset:offset + size]))
    return tfb._handle(handle)[:2]


def _rewrite_entries(prefix, edit):
    entries = list(tfb.read_table(prefix + ".index"))
    writer.write_table(prefix + ".index", [edit(k, v) for k, v in entries])


def _break(case, prefix):
    if case == "crc":
        with open(prefix + ".data-00000-of-00001", "r+b") as fh:
            fh.seek(20)  # inside "w", which follows "v"'s 12 bytes
            b = fh.read(1)
            fh.seek(20)
            fh.write(bytes([b[0] ^ 1]))
    elif case == "missing_shard":
        os.remove(prefix + ".data-00000-of-00001")
    elif case in ("compression", "block_crc"):
        index = bytearray(open(prefix + ".index", "rb").read())
        offset, size = _data_block(index)
        if case == "compression":  # snappy, with a valid block checksum
            index[offset + size] = 1
            index[offset + size + 1:offset + size + 5] = struct.pack(
                "<I", tfb.masked_crc32c(bytes(index[offset:offset + size + 1])))
        else:
            index[offset + 3] ^= 0x40
        open(prefix + ".index", "wb").write(index)
    elif case == "v1":
        for path in glob.glob(prefix + ".*"):
            os.remove(path)
        open(prefix, "wb").write(b"a V1 checkpoint is one table file")
    elif case == "slices":
        _rewrite_entries(prefix, lambda k, v: (
            k, v + writer._bytes_field(7, b"") if k == b"w" else v))
    elif case == "big_endian":
        _rewrite_entries(prefix, lambda k, v: (
            k, v + writer._varint_field(2, 1) if k == b"" else v))


REFUSALS = {
    "crc": (ValueError, "'w': crc32c mismatch"),
    "missing_shard": (FileNotFoundError,
                      r"data-00000-of-00001: data shard 0 of 1"),
    "compression": (ValueError, "block compression type 1"),
    "block_crc": (ValueError, r"block checksum \(crc32c\) mismatch"),
    "v1": (ValueError, "TF V1 checkpoint"),
    "slices": (ValueError, "'w' is a partitioned variable"),
    "big_endian": (ValueError, "big-endian"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_reader_refuses_what_it_does_not_read(tmp_path, case):
    prefix = str(tmp_path / "ck")
    writer.write_bundle(prefix, {"w": np.arange(12, dtype=np.float32),
                                 "v": np.ones(3, np.float32)})
    _break(case, prefix)
    error, match = REFUSALS[case]
    with pytest.raises(error, match=match):
        tfb.CheckpointReader(prefix).get_tensor("w")


def test_unknown_proto_fields_are_skipped(tmp_path):
    prefix = str(tmp_path / "ck")
    tensors = {"w": np.arange(4, dtype=np.float32)}
    writer.write_bundle(prefix, tensors)
    # an unknown varint, fixed64, bytes and fixed32 field on every entry
    extra = (writer._varint_field(40, 7) + writer._varint(41 << 3 | 1)
             + b"\x01" * 8 + writer._bytes_field(42, b"xyz")
             + writer._varint(43 << 3 | 5) + b"\x02" * 4)
    _rewrite_entries(prefix, lambda k, v: (k, v + extra))
    _assert_reads_back(tfb.CheckpointReader(prefix), tensors)


def test_absent_prefix_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"nothing\.index"):
        tt.load_model(str(tmp_path / "nothing"))


# -- against TensorFlow --------------------------------------------------

TF_SCRIPT = r'''
import json, sys
import numpy as np
import tensorflow as tf
from tensorflow.python.training import py_checkpoint_reader

from deepmod_tpu.models import tf_import as jt

work, golden = sys.argv[1], sys.argv[2]
tf1 = tf.compat.v1
src = dict(np.load(work + "/source.npz"))


def save(prefix, named):
    g = tf1.Graph()
    with g.as_default():
        vs = [tf1.Variable(v, name=k) for k, v in named.items()]
        step = tf1.train.get_or_create_global_step()
        loss = tf.add_n([tf.reduce_sum(v) for v in vs])
        # the slots and beta powers a reference trainer's Saver stores
        tf1.train.AdamOptimizer(1e-3).minimize(loss, global_step=step)
        saver = tf1.train.Saver()
        init = tf1.global_variables_initializer()
    with tf1.Session(graph=g) as sess:
        sess.run(init)
        saver.save(sess, prefix)


rnn = {}
for d in ("fw", "bw"):
    for l in range(3):
        cell = f"bidirectional_rnn/{d}/multi_rnn_cell/cell_{l}/basic_lstm_cell"
        rnn[cell + "/kernel"] = src[f"{d}/{l}/kernel"]
        rnn[cell + "/bias"] = src[f"{d}/{l}/bias"]
rnn["Variable"] = src["out_w"]
rnn["Variable_1"] = src["out_b"]
save(work + "/tf_bilstm/mod_train", rnn)
save(work + "/tf_cluster/Cg.cov5.nb25", dict(np.load(golden)))


def dump(prefix, name):
    r = py_checkpoint_reader.NewCheckpointReader(prefix)
    shapes = r.get_variable_to_shape_map()
    dtypes = {k: v.name for k, v in r.get_variable_to_dtype_map().items()}
    arrays = {}
    for k in shapes:
        t = np.asarray(r.get_tensor(k))
        arrays[k] = t.astype(np.float32) if dtypes[k] == "bfloat16" else t
    json.dump({"shapes": shapes, "dtypes": dtypes},
              open(f"{work}/{name}.json", "w"))
    np.savez(f"{work}/{name}.npz", **arrays)


dump(work + "/tf_bilstm/mod_train", "tf_read_bilstm")
dump(work + "/tf_cluster/Cg.cov5.nb25", "tf_read_cluster")
dump(work + "/port/ck", "tf_read_port")

params, cfg = jt.load_bilstm_checkpoint(work + "/tf_bilstm/mod_train")
flat = jt._flatten_bilstm_tree(params)
np.savez(work + "/jax_bilstm.npz", **flat)
inferred = jt.bilstm_config_from_checkpoint(work + "/tf_bilstm/mod_train")
json.dump({k: getattr(inferred, k) for k in
           ("num_input", "num_hidden", "num_layers", "num_classes")},
          open(work + "/jax_config.json", "w"))
cparams, ccfg = jt.load_cluster_checkpoint(work + "/tf_cluster/Cg.cov5.nb25")
np.savez(work + "/jax_cluster.npz", **cparams)
'''


@pytest.fixture(scope="module")
def tf_run(tmp_path_factory):
    """One TF subprocess: writes the two Saver checkpoints, dumps what TF's
    reader reads from them and from a port-written bundle, and the JAX
    package's loaders' params."""
    pytest.importorskip("tensorflow")
    work = str(tmp_path_factory.mktemp("tf_import"))
    source = tb.init_bilstm_params(7, tb.BiLSTMConfig(), device="cpu")
    np.savez(os.path.join(work, "source.npz"), **tt._flatten(source))
    os.makedirs(os.path.join(work, "port"))
    tensors = _every_dtype()
    writer.write_bundle(os.path.join(work, "port", "ck"), tensors,
                        bfloat16=["x/bfloat16"])
    proc = subprocess.run(
        [sys.executable, "-c", TF_SCRIPT, work, GOLDEN],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2"),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return work, source, tensors


def _tf_read(work, name):
    meta = json.load(open(os.path.join(work, name + ".json")))
    data = np.load(os.path.join(work, name + ".npz"))
    return meta, {k: data[k] for k in data.files}


@pytest.mark.parametrize("which", ["bilstm", "cluster"])
def test_saver_checkpoints_read_as_tf_reads_them(tf_run, which):
    work = tf_run[0]
    prefix = {"bilstm": "tf_bilstm/mod_train",
              "cluster": "tf_cluster/Cg.cov5.nb25"}[which]
    reader = tfb.CheckpointReader(os.path.join(work, prefix))
    meta, arrays = _tf_read(work, "tf_read_" + which)
    names = reader.get_variable_to_shape_map()
    assert names == meta["shapes"]
    assert reader.get_variable_to_dtype_map() == meta["dtypes"]
    # the Saver also stored Adam slots, beta powers and the global step
    assert "global_step" in names and "beta1_power" in names
    assert sum(k.endswith("/Adam_1") for k in names) == (
        14 if which == "bilstm" else 6)
    for k, want in arrays.items():
        got = reader.get_tensor(k)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k


def test_tf_reads_the_port_writer(tf_run):
    work, _, tensors = tf_run
    meta, arrays = _tf_read(work, "tf_read_port")
    assert meta["shapes"] == {k: list(np.shape(v)) for k, v in tensors.items()}
    for k, want in tensors.items():
        want = np.asarray(want)
        assert meta["dtypes"][k] == ("bfloat16" if k == "x/bfloat16"
                                     else want.dtype.name), k
        assert arrays[k].dtype == want.dtype, k
        assert arrays[k].tobytes() == want.tobytes(), k


def test_loaders_give_the_jax_params(tf_run):
    work, source, _ = tf_run
    prefix = os.path.join(work, "tf_bilstm", "mod_train")
    params, cfg = tt.load_model(prefix)
    want = np.load(os.path.join(work, "jax_bilstm.npz"))
    got = tt._flatten(params)
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].tobytes() == want[k].tobytes(), k
    src = tt._flatten(source)
    assert all(got[k].tobytes() == src[k].tobytes() for k in src)
    jcfg = json.load(open(os.path.join(work, "jax_config.json")))
    for c in (cfg, tt.bilstm_config_from_checkpoint(prefix)):
        assert {k: getattr(c, k) for k in jcfg} == jcfg

    cparams, ccfg = tt.load_cluster_checkpoint(
        os.path.join(work, "tf_cluster", "Cg.cov5.nb25"))
    cwant = np.load(os.path.join(work, "jax_cluster.npz"))
    assert sorted(cparams) == sorted(cwant.files)
    for k in cwant.files:
        assert cparams[k].tobytes() == cwant[k].tobytes(), k
    assert (ccfg.num_input, ccfg.hidden1, ccfg.hidden2) == (14, 100, 20)


def test_logits_from_the_tf_prefix_match_jax(tf_run):
    work = tf_run[0]
    params, cfg = tt.load_model(os.path.join(work, "tf_bilstm", "mod_train"))
    x = np.random.default_rng(8).standard_normal((9, 21, 7)).astype(np.float32)
    got = tb.bilstm_logits(tt.params_from_numpy(params, "cpu"),
                           torch.from_numpy(x), cfg).numpy()
    jparams = tt._unflatten(np.load(os.path.join(work, "jax_bilstm.npz")), 3)
    want = np.asarray(jb.bilstm_logits(
        jparams, jnp.asarray(x), jb.BiLSTMConfig(num_input=7)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_stripped_checkpoint_still_gives_its_config(tf_run, tmp_path):
    """The reference strips its BiLSTM checkpoints' .data files: the shapes
    still give the config, and loading names the missing shard."""
    work = tf_run[0]
    prefix = str(tmp_path / "mod_train")
    shutil.copy(os.path.join(work, "tf_bilstm", "mod_train.index"),
                prefix + ".index")
    cfg = tt.bilstm_config_from_checkpoint(prefix)
    assert (cfg.num_input, cfg.num_hidden, cfg.num_layers) == (7, 100, 3)
    with pytest.raises(FileNotFoundError, match=r"mod_train\.data-00000"):
        tt.load_model(prefix)


# -- through the commands --------------------------------------------------

def _cli(*argv):
    with contextlib.redirect_stdout(io.StringIO()):
        assert torch_cli.main(list(argv)) == 0


def _read_all(pattern):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(pattern))}


def test_detect_from_a_tf_prefix_gives_the_npz_beds(tmp_path):
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        write_move_dataset_pod5,
    )

    ds = str(tmp_path / "ds")
    write_move_dataset_pod5(ds, SynthConfig(
        genome_sizes={"chrS": 9000}, num_reads=3, read_length=(500, 800),
        seed=21, fast5_style="move"))
    cfg = tb.BiLSTMConfig(num_hidden=16)
    params = tb.init_bilstm_params(5, cfg, device="cpu")
    tt.save_bilstm_npz(os.path.join(ds, "m.npz"), params, cfg)
    writer.write_reference_bilstm(os.path.join(ds, "mod_train"), params)
    beds = {}
    for model in ("m.npz", "mod_train"):
        out = str(tmp_path / model)
        _cli("detect", "--wrkBase", os.path.join(ds, "pod5"),
             "--Ref", os.path.join(ds, "ref.fa"),
             "--modfile", os.path.join(ds, model), "--hidden", "16",
             "--basecalls", os.path.join(ds, "calls.bam"),
             "--outFolder", out, "--alignStr", "builtin", "--precision",
             "fp32", "--device", "cpu", "--perRead", "0", "--threads", "1")
        beds[model] = _read_all(os.path.join(out, "mod_pos.*.bed"))
    assert beds["m.npz"] and all(beds["m.npz"].values())
    assert beds["mod_train"] == beds["m.npz"]


def test_clusterpred_from_a_tf_prefix_gives_the_npz_output(tmp_path):
    rng = np.random.RandomState(4)
    motif = tmp_path / "motif"
    motif.mkdir()
    cg = np.unique(rng.randint(0, 3000, 300)) * 2
    with open(motif / "motif_chr1_C.bed", "w") as fh:
        for p in cg:
            fh.write(f"chr1\t{p}\t+\nchr1\t{p + 1}\t-\n")
    with open(tmp_path / "pred.chr1.C.bed", "w") as fh:
        for p in cg:
            for strand, pos in (("+", p), ("-", p + 1)):
                cov = int(rng.randint(1, 30))
                mod = int(rng.binomial(cov, rng.rand()))
                fh.write("chr1 %d %d C %d %s  %d %d 0,0,0 %d %d %d\n" % (
                    pos, pos + 1, cov, strand, pos, pos + 1, cov,
                    int(mod * 100 / cov), mod))
    prefix = str(tmp_path / "Cg.cov5.nb25")
    writer.write_reference_cluster(prefix, dict(np.load(GOLDEN)))
    out = {}
    for model in (GOLDEN, prefix):
        _cli("clusterpred", str(tmp_path / "pred"), str(motif), "--model",
             model, "--chrs", "chr1", "--device", "cpu")
        out[model] = open(tmp_path / "pred_clusterCpG.chr1.C.bed", "rb").read()
    assert out[GOLDEN] and out[prefix] == out[GOLDEN]
