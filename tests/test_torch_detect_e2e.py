"""The port's detect pipeline end to end on the CPU against the JAX one.

One synthetic dataset (the SynthConfig of tests/test_detect_e2e.py) and
one .npz model go through JAX ``detect_run`` (CPU, scan path) and the
port's ``detect_run(device='cpu', precision='fp32')``. Both runs write to
the same out folder path in turn (renamed away after each), so even the
index files' absolute-path headers must match byte for byte.
"""

import dataclasses
import glob
import os
import shutil
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest

from deepmod_tpu.engine.detect import DetectConfig as JaxDetectConfig
from deepmod_tpu.engine.detect import detect_run as jax_detect_run
from deepmod_tpu.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu.models.tf_import import save_bilstm_npz
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_into(root, name, fn, cfg):
    """Run detect into <root>/run, then move it to <root>/<name>."""
    res = fn(cfg)
    shutil.move(os.path.join(root, "run"), os.path.join(root, name))
    os.rename(os.path.join(root, "run.done"),
              os.path.join(root, name + ".done"))
    return res


def _files(root, name, pattern):
    return sorted(
        os.path.relpath(p, os.path.join(root, name))
        for p in glob.glob(os.path.join(root, name, pattern), recursive=True)
    )


def _assert_same_bytes(root, a, b, pattern):
    fa, fb = _files(root, a, pattern), _files(root, b, pattern)
    assert fa and fa == fb, (fa, fb)
    for rel in fa:
        with open(os.path.join(root, a, rel), "rb") as x, \
                open(os.path.join(root, b, rel), "rb") as y:
            assert x.read() == y.read(), rel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_e2e"))
    generate_dataset(root, SynthConfig(
        genome_sizes={"chrS": 20000}, num_reads=6, read_length=(700, 1200),
        seed=9,
    ))
    model_config = BiLSTMConfig(num_input=7)
    model = os.path.join(root, "model.npz")
    save_bilstm_npz(
        model, init_bilstm_params(jax.random.PRNGKey(0), model_config),
        model_config,
    )
    common = dict(
        wrk_base=os.path.join(root, "fast5"), ref=os.path.join(root, "ref.fa"),
        model_path=model, out_folder=os.path.join(root, "run"),
        file_id="mod", base="C", align_str="builtin",
    )
    jax_cfg = JaxDetectConfig(**common)
    torch_cfg = DetectConfig(**common, device="cpu", precision="fp32")
    res = {
        "jax": _run_into(root, "jax", jax_detect_run, jax_cfg),
        "torch": _run_into(root, "torch", detect_run, torch_cfg),
        "jax_t": _run_into(root, "jax_t", jax_detect_run,
                           dataclasses.replace(jax_cfg, target_only=True)),
        "torch_t": _run_into(root, "torch_t", detect_run,
                             dataclasses.replace(torch_cfg, target_only=True)),
    }
    return root, common, res


@pytest.fixture(scope="module")
def runs_w20(runs):
    """The same dataset and model through both packages at windowsize 20:
    even T, the port's layered path (K4's plain version on the CPU)
    against the JAX scan path."""
    root, common, _ = runs
    res = {
        "jax_w20": _run_into(root, "jax_w20", jax_detect_run,
                             JaxDetectConfig(**common, window_size=20)),
        "torch_w20": _run_into(root, "torch_w20", detect_run, DetectConfig(
            **common, window_size=20, device="cpu", precision="fp32")),
    }
    return root, res


def test_windowsize20_outputs_byte_identical(runs_w20):
    root, res = runs_w20
    ra, rb = res["jax_w20"], res["torch_w20"]
    assert rb.num_reads == ra.num_reads == 6
    assert rb.num_windows == ra.num_windows > 0
    assert rb.errors == ra.errors
    _assert_same_bytes(root, "jax_w20", "torch_w20", "mod_pos.*.bed")
    _assert_same_bytes(root, "jax_w20", "torch_w20", "mod/rnn.pred.ind.*")


def test_counts_and_errors_equal(runs):
    _, _, res = runs
    for a, b in (("jax", "torch"), ("jax_t", "torch_t")):
        ra, rb = res[a], res[b]
        assert rb.num_reads == ra.num_reads == 6
        assert rb.num_windows == ra.num_windows > 0
        assert rb.errors == ra.errors
        assert [os.path.basename(p) for p in rb.bed_files] == [
            os.path.basename(p) for p in ra.bed_files]


def test_beds_byte_identical(runs):
    root, _, _ = runs
    _assert_same_bytes(root, "jax", "torch", "mod_pos.*.bed")
    _assert_same_bytes(root, "jax_t", "torch_t", "mod_pos.*.bed")
    # targetOnly is BED-identical to the full run
    for rel in _files(root, "jax", "mod_pos.*.bed"):
        with open(os.path.join(root, "jax", rel), "rb") as x, \
                open(os.path.join(root, "torch_t", rel), "rb") as y:
            assert x.read() == y.read(), rel


def test_index_files_byte_identical(runs):
    root, _, _ = runs
    _assert_same_bytes(root, "jax", "torch", "mod/rnn.pred.ind.*")


def test_predetail_datasets_equal(runs):
    root, _, _ = runs
    pattern = "mod/**/rnn.pred.detail.fast5.*"
    fa, fb = _files(root, "jax", pattern), _files(root, "torch", pattern)
    assert fa and fa == fb
    n = 0
    for rel in fa:
        with h5py.File(os.path.join(root, "jax", rel), "r") as a, \
                h5py.File(os.path.join(root, "torch", rel), "r") as b:
            assert sorted(a["pred"]) == sorted(b["pred"])
            for key in a["pred"]:
                ga, gb = a["pred"][key], b["pred"][key]
                assert dict(ga.attrs) == dict(gb.attrs)
                da, db = ga["predetail"][()], gb["predetail"][()]
                assert da.dtype == db.dtype
                np.testing.assert_array_equal(da, db)
                n += 1
    assert n == 6


def test_pod5_writer_matches_fast5_conversion(tmp_path):
    """write_move_dataset_pod5 (no h5py) writes the reads, signals, moves
    and trims that the JAX package's move-style fast5 dataset converts to,
    and a port detect over the pod5+BAM pair gives the BEDs of a JAX
    detect over the fast5 files."""
    from deepmod_tpu.align.alignfile import read_basecalls as jax_read_bc
    from deepmod_tpu.io.pod5 import read_pod5 as jax_read_pod5
    from deepmod_tpu.testing.synthetic import convert_move_dataset_to_pod5
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig as TorchSynthConfig,
        write_move_dataset_pod5,
    )

    kw = dict(genome_sizes={"chrP": 15000}, num_reads=5,
              read_length=(700, 1100), seed=23, fast5_style="move")
    ref_dir = str(tmp_path / "f5")
    _, jreads = generate_dataset(ref_dir, SynthConfig(**kw))
    convert_move_dataset_to_pod5(
        os.path.join(ref_dir, "fast5"), str(tmp_path / "conv.pod5"),
        str(tmp_path / "conv.bam"),
    )
    pod_dir = str(tmp_path / "pod")
    genome, treads, id_map = write_move_dataset_pod5(
        pod_dir, TorchSynthConfig(**kw))
    assert [r.seq for r in treads] == [r.seq for r in jreads]
    with open(os.path.join(ref_dir, "ref.fa"), "rb") as a, \
            open(os.path.join(pod_dir, "ref.fa"), "rb") as b:
        assert a.read() == b.read()
    want = {r.read_id: r.signal for r in jax_read_pod5(str(tmp_path / "conv.pod5"))}
    got = {r.read_id: r.signal for r in jax_read_pod5(
        os.path.join(pod_dir, "pod5", "reads.pod5"))}
    assert want.keys() == got.keys() and len(got) == 5
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    bc_want = jax_read_bc(str(tmp_path / "conv.bam"))
    bc_got = jax_read_bc(os.path.join(pod_dir, "calls.bam"))
    assert bc_want.keys() == bc_got.keys()
    for rid, w in bc_want.items():
        g = bc_got[rid]
        assert (g.seq, g.stride, g.trim) == (w.seq, w.stride, w.trim)
        np.testing.assert_array_equal(g.moves, w.moves)

    model_config = BiLSTMConfig(num_input=7)
    model = str(tmp_path / "model.npz")
    save_bilstm_npz(
        model, init_bilstm_params(jax.random.PRNGKey(3), model_config),
        model_config,
    )
    res_f5 = jax_detect_run(JaxDetectConfig(
        wrk_base=os.path.join(ref_dir, "fast5"),
        ref=os.path.join(ref_dir, "ref.fa"), model_path=model,
        out_folder=str(tmp_path / "out_f5"), move=True, align_str="builtin",
    ))
    res_pod = detect_run(DetectConfig(
        wrk_base=os.path.join(pod_dir, "pod5"),
        ref=os.path.join(pod_dir, "ref.fa"), model_path=model,
        out_folder=str(tmp_path / "out_pod"), move=True, align_str="builtin",
        basecalls=os.path.join(pod_dir, "calls.bam"), write_per_read=False,
        device="cpu", precision="fp32",
    ))
    assert res_pod.num_reads == res_f5.num_reads > 0
    assert res_pod.num_windows == res_f5.num_windows
    beds = sorted(os.path.basename(p) for p in res_f5.bed_files)
    assert beds and beds == sorted(os.path.basename(p) for p in res_pod.bed_files)
    for name in beds:
        with open(str(tmp_path / "out_f5" / name), "rb") as a, \
                open(str(tmp_path / "out_pod" / name), "rb") as b:
            assert a.read() == b.read(), name


def test_cli_detect_on_cpu(runs, tmp_path):
    root, common, _ = runs
    out = str(tmp_path / "cli_out")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepmod_tpu_torch", "detect",
         "--wrkBase", common["wrk_base"], "--Ref", common["ref"],
         "--modfile", common["model_path"], "--outFolder", out,
         "--alignStr", "builtin", "--precision", "fp32", "--device", "cpu",
         "--trace", str(tmp_path / "trace")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "detect done: 6 reads" in proc.stdout
    assert os.path.getsize(str(tmp_path / "trace" / "detect.json")) > 0
    names = _files(root, "jax", "mod_pos.*.bed")
    for rel in names:
        with open(os.path.join(root, "jax", rel), "rb") as a, \
                open(os.path.join(out, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_unported_options_raise(runs, tmp_path):
    """No detect option is left unported: a fnum-57 predictor builds
    (tests below), and device aggregation runs, staying on the
    host path with one device (several: tests/test_torch_parallel.py;
    --predDet 0 and --mod_cluster: tests/test_torch_summarize.py)."""
    _, common, _ = runs
    from deepmod_tpu_torch.engine.detect import WindowPredictor
    from deepmod_tpu_torch.models import bilstm as tb

    cfg = tb.BiLSTMConfig(num_input=57, num_hidden=8, num_layers=1)
    params = tb.init_bilstm_params(0, cfg, device="cpu")
    assert WindowPredictor(params, cfg, device="cpu").config.num_input == 57
    base = DetectConfig(**dict(common, out_folder=str(tmp_path / "x")),
                        device="cpu", precision="fp32")
    res = detect_run(dataclasses.replace(base, device_aggregation=True))
    assert res.num_reads == 6 and "device_aggregation" not in res.stage_seconds


def _hist_features(rows: int = 700):
    """fnum-57 engine-shaped rows (tests/test_detect_e2e.py's): 50 integer
    histogram counts < 40, a 0/1 one-hot (or none), 3 numbers."""
    rng = np.random.default_rng(13)
    feats = np.zeros((rows, 57), np.float32)
    feats[:, :50] = rng.integers(0, 40, (rows, 50))
    hot = rng.integers(0, 5, rows)
    for b in range(4):
        feats[hot == b, 50 + b] = 1.0
    feats[:, 54] = (rng.standard_normal(rows) * 2).round(3)
    feats[:, 55] = np.abs(rng.standard_normal(rows) * 2).round(3)
    feats[:, 56] = rng.integers(1, 40, rows)
    return feats, np.arange(12, rows - 12, dtype=np.int64)


@pytest.fixture(scope="module")
def hist_model():
    from deepmod_tpu_torch.models import bilstm as tb
    from deepmod_tpu_torch.models.tf_import import params_to_numpy

    cfg = tb.BiLSTMConfig(num_input=57, num_hidden=32)
    return cfg, params_to_numpy(tb.init_bilstm_params(9, cfg, device="cpu"))


def test_predictor_packed_hist_matches_jax(hist_model, monkeypatch):
    """The port's one compact path at fnum 57 (fp32 rows, 228 B a row
    shipped) gives the predictions of the JAX package's packed predictor
    (its histogram pack switched on for it alone; fp32, scan path) and of
    the port's materialized windows."""
    from deepmod_tpu.engine.detect import WindowPredictor as JaxPredictor
    from deepmod_tpu.models.bilstm import BiLSTMConfig as JaxConfig
    from deepmod_tpu_torch.engine.detect import WindowPredictor

    feats, centers = _hist_features()
    cfg, params = hist_model
    monkeypatch.setenv("DMT_COMPACT_PACK57", "1")
    jpred = JaxPredictor(params, JaxConfig(num_input=57, num_hidden=32),
                         buckets=(64, 256), use_pallas=False,
                         data_parallel=False, compact_transfer=True)
    want = jpred.predict_from_features(feats, centers)
    assert "hist" in jpred._compact_fns
    monkeypatch.delenv("DMT_COMPACT_PACK57")
    kw = dict(buckets=(64, 256), device="cpu", precision="fp32")
    plain = WindowPredictor(params, cfg, compact_transfer=True, **kw)
    win = WindowPredictor(params, cfg, compact_transfer=False, **kw)
    got = plain.predict_from_features(feats, centers)
    assert 0 < int(want.sum()) < len(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, win.predict_from_features(feats, centers))
    # the 676 centers' chunks: 256, 256 and the 224 rows the last 204 read
    assert plain.transfer_bytes == (2 * 256 + 224) * 57 * 4
