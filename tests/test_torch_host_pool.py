"""HostPool in the port: detect's host stage in spawn workers.

``deepmod_tpu_torch/engine/host_pool.py`` runs ingest, alignment, features
and the per-read outputs of each file batch in spawn workers, while the
engine process alone classifies. These tests mirror the JAX package's pool
tests (``tests/test_detect_e2e.py``): a pooled run over several batches
gives the single-process run's BEDs, index files and predetail HDF5 byte
for byte, and the JAX package's single-process BEDs and index files on the
same weights; one pool serves two runs; a pool built for other
HostOptions is refused; targetOnly holds under the pool; a killed worker
is a census error and the run ends; a run whose predictor raises leaves a
shared pool reusable. A fresh interpreter that imports what a worker
imports holds no ``torch``.
"""

import dataclasses
import glob
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import pytest
import torch

from deepmod_tpu.engine.detect import DetectConfig as JaxDetectConfig
from deepmod_tpu.engine.detect import detect_run as jax_detect_run
from deepmod_tpu.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu.models.tf_import import save_bilstm_npz
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu_torch.engine.detect import (
    DetectConfig,
    WindowPredictor,
    _host_options,
    detect_run,
)
from deepmod_tpu_torch.engine.host_pool import HostPool
from deepmod_tpu_torch.models.tf_import import load_model
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_into(root, name, fn, cfg, **kw):
    """Run detect into <root>/run, then move it to <root>/<name> (the
    index files name their output folder)."""
    res = fn(cfg, **kw)
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


def _assert_same_run(root, a, b, predetail=False):
    _assert_same_bytes(root, a, b, "mod_pos.*.bed")
    _assert_same_bytes(root, a, b, "mod/rnn.pred.ind.*")
    if predetail:
        _assert_same_bytes(root, a, b, "mod/*/*")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX e2e dataset (6 reads) and weights; single-process runs of
    both packages over batches of 3 files."""
    root = str(tmp_path_factory.mktemp("torch_pool"))
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
        file_id="mod", base="C", align_str="builtin", files_per_batch=3,
    )
    cfg = DetectConfig(**common, device="cpu", precision="fp32")
    res = {
        "jax": _run_into(root, "jax", jax_detect_run,
                         JaxDetectConfig(**common)),
        "torch": _run_into(root, "torch", detect_run, cfg),
    }
    assert res["torch"].num_reads == 6 and res["torch"].errors == {}
    return root, common, cfg, res


def test_pooled_run_matches_single_process_and_jax(runs):
    """threads 2 over batches of 3 files: the JAX test's case
    (test_multiprocess_host_ingestion), held to the port's single-process
    run byte for byte (BEDs, index files, predetail HDF5) and to the JAX
    package's BEDs and index files."""
    root, _, cfg, res = runs
    pooled = _run_into(root, "pool", detect_run,
                       dataclasses.replace(cfg, threads=2))
    assert pooled.num_reads == res["torch"].num_reads == res["jax"].num_reads
    assert pooled.num_windows == res["torch"].num_windows > 0
    assert pooled.errors == {}
    assert "host_ingest_align_features" not in pooled.stage_seconds
    assert pooled.stage_seconds["device_inference"] > 0
    _assert_same_run(root, "torch", "pool", predetail=True)
    _assert_same_run(root, "jax", "pool")


def test_cli_detect_threads_over_batches(runs):
    """The CLI's --threads over several --files_per_thread batches runs
    through the pool (it raised before HostPool was ported)."""
    from deepmod_tpu_torch.cli import main as cli_main

    root, _, cfg, _ = runs
    rc = cli_main([
        "detect", "--wrkBase", cfg.wrk_base, "--Ref", cfg.ref,
        "--modfile", cfg.model_path, "--outFolder", cfg.out_folder,
        "--alignStr", "builtin", "--precision", "fp32", "--device", "cpu",
        "--threads", "3", "--files_per_thread", "2", "--outLevel", "0",
    ])
    assert rc == 0
    shutil.move(cfg.out_folder, os.path.join(root, "cli"))
    os.remove(cfg.out_folder + ".done")
    _assert_same_bytes(root, "torch", "cli", "mod_pos.*.bed")


def test_host_pool_persistent_across_runs(runs):
    """One HostPool passed to two runs: the same worker processes, byte-
    identical outputs."""
    root, _, cfg, res = runs
    cfg1 = dataclasses.replace(cfg, threads=2)
    pool = HostPool(2, _host_options(cfg1))
    try:
        r1 = _run_into(root, "pool1", detect_run, cfg1, host_pool=pool)
        pids = [p.pid for p in pool._procs]
        r2 = _run_into(root, "pool2", detect_run, cfg1, host_pool=pool)
        assert [p.pid for p in pool._procs] == pids
        assert all(p.is_alive() for p in pool._procs)
    finally:
        pool.close()
    assert r1.num_reads == r2.num_reads == res["torch"].num_reads
    assert r1.num_windows == r2.num_windows == res["torch"].num_windows
    _assert_same_run(root, "torch", "pool1")
    _assert_same_run(root, "torch", "pool2")


def test_host_pool_rejects_mismatched_options(runs):
    _, _, cfg, _ = runs
    cfg = dataclasses.replace(cfg, threads=2)
    pool = HostPool(1, _host_options(dataclasses.replace(cfg, fnum=57)))
    try:
        with pytest.raises(ValueError, match="different HostOptions"):
            detect_run(cfg, host_pool=pool)
    finally:
        pool.close()


def test_pooled_target_only_matches(runs):
    """targetOnly under the pool (worker-side outputs, COO merge) gives the
    baseline BEDs and the JAX package's targetOnly BEDs. Device
    aggregation, the JAX test's other case, is not ported yet and raises
    (tests/test_torch_detect_e2e.py)."""
    root, common, cfg, _ = runs
    _run_into(root, "jax_t", jax_detect_run,
              JaxDetectConfig(**common, target_only=True))
    res = _run_into(root, "pool_t", detect_run,
                    dataclasses.replace(cfg, target_only=True, threads=2))
    assert res.num_reads == 6, res.errors
    _assert_same_bytes(root, "torch", "pool_t", "mod_pos.*.bed")
    _assert_same_run(root, "jax_t", "pool_t")


def test_host_pool_worker_death_is_survivable(runs, tmp_path):
    """A worker killed before the run: its batches are census errors (or
    never routed to it) and the run ends on the survivor."""
    _, _, cfg, res = runs
    cfg = dataclasses.replace(cfg, out_folder=str(tmp_path / "death"),
                              threads=2, files_per_batch=2)
    pool = HostPool(2, _host_options(cfg))
    try:
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        time.sleep(0.2)
        out = detect_run(cfg, host_pool=pool)
    finally:
        pool.close()
    failed = sum(len(v) for k, v in out.errors.items()
                 if k.startswith("Batch worker failed"))
    assert out.num_reads + 2 * failed >= res["torch"].num_reads
    assert out.num_reads > 0


def test_host_pool_survives_crashed_run(runs):
    """A run whose classifier raises mid-flight leaves a SHARED pool
    reusable: the next run through it gives the baseline's outputs."""
    root, _, cfg, res = runs

    class Exploding:
        def __init__(self, inner):
            self.inner = inner
            self.config = inner.config
            self.calls = 0

        def predict_from_features(self, feats, centers, window=21, **kw):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("injected device failure")
            return self.inner.predict_from_features(feats, centers, window,
                                                    **kw)

    params, model_config = load_model(cfg.model_path)
    inner = WindowPredictor(params, model_config, device="cpu",
                            precision="fp32")
    cfg = dataclasses.replace(cfg, threads=2, files_per_batch=2)
    pool = HostPool(2, _host_options(cfg))
    try:
        with pytest.raises(RuntimeError, match="injected device failure"):
            detect_run(cfg, Exploding(inner), host_pool=pool)
        assert pool._inflight == {}  # abandoned cleanly
        shutil.rmtree(cfg.out_folder)
        out = _run_into(root, "crash2", detect_run, cfg, predictor=inner,
                        host_pool=pool)
    finally:
        pool.close()
    assert out.num_reads == res["torch"].num_reads, out.errors
    _assert_same_bytes(root, "torch", "crash2", "mod_pos.*.bed")


def test_worker_modules_import_no_torch(runs):
    """What a spawned worker imports (host_pool, host_worker, outputs,
    summarize) and runs (the host stage of a batch, the --mod_cluster
    rescue) loads no torch."""
    _, _, cfg, _ = runs
    code = (
        "import glob, sys\n"
        "from deepmod_tpu_torch.engine import host_pool\n"
        "from deepmod_tpu_torch.engine import host_worker, outputs, "
        "summarize\n"
        "from deepmod_tpu_torch.engine.host_worker import HostOptions\n"
        f"host_worker.init_worker({_host_options(cfg)!r})\n"
        f"files = sorted(glob.glob({cfg.wrk_base!r} + '/**/*.fast5',"
        " recursive=True))\n"
        "results, errors = host_worker.host_process_files(files[:2])\n"
        "outputs.build_batch_request(results, None)\n"
        "summarize.apply_mod_cluster_rescue(results[0].base_map)\n"
        "assert results and not errors, errors\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_pod5_files_pooled_match_one_file(tmp_path):
    """The smoke's layout: move-table reads over several pod5 files with
    one basecall BAM. Pooled over batches of 2 files, detect gives the
    BEDs and index files of a single-process run over the same reads in
    one pod5 file, up to the file names in the index entries."""
    from deepmod_tpu_torch.models.bilstm import BiLSTMConfig as TorchConfig
    from deepmod_tpu_torch.models.bilstm import init_bilstm_params as init
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz as save
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig as TorchSynth,
        write_move_dataset_pod5,
    )

    synth = TorchSynth(genome_sizes={"chrS": 15000}, num_reads=8,
                       read_length=(600, 900), seed=21, fast5_style="move")
    root = str(tmp_path)
    for tag, n_files in (("one", 1), ("many", 5)):
        _, reads, _ = write_move_dataset_pod5(os.path.join(root, tag), synth,
                                              n_files=n_files)
        assert len({r.path for r in reads}) == n_files
    files = sorted(glob.glob(os.path.join(root, "many", "pod5", "*.pod5")))
    assert len(files) == 5
    model = os.path.join(root, "model.npz")
    cfg = TorchConfig(num_input=7)
    save(model, init(3, cfg, device="cpu"), cfg)
    outs = {}
    for tag, threads, per_batch in (("one", 1, 1000), ("many", 2, 2)):
        ds = os.path.join(root, tag)
        outs[tag] = _run_into(root, f"out_{tag}", detect_run, DetectConfig(
            wrk_base=os.path.join(ds, "pod5"), ref=os.path.join(ds, "ref.fa"),
            model_path=model, out_folder=os.path.join(root, "run"),
            align_str="builtin", basecalls=os.path.join(ds, "calls.bam"),
            threads=threads, files_per_batch=per_batch, device="cpu",
            precision="fp32",
        ))
    assert outs["many"].num_reads == outs["one"].num_reads > 0
    assert outs["many"].num_windows == outs["one"].num_windows
    assert outs["many"].errors == outs["one"].errors
    _assert_same_bytes(root, "out_one", "out_many", "mod_pos.*.bed")
    # an index entry names the read's input file, its predetail batch
    # file and its key there, which differ between the layouts; the
    # read's chromosome, strand and position must not
    for rel in _files(root, "out_one", "mod/rnn.pred.ind.*"):
        rows = []
        for tag in ("one", "many"):
            with open(os.path.join(root, f"out_{tag}", rel)) as fh:
                rows.append(sorted(ln.split()[:3]
                                   for ln in fh if not ln.startswith("#")))
        assert rows[0] and rows[0] == rows[1]


def test_move_table_events_matches_jax():
    """The port's move_table_events finds the event boundaries in one numpy
    pass; its start, length and model_state columns are the JAX
    package's (MoveTable.py's) on random move tables, ragged ends
    included, and it raises on every table where the JAX package does.
    Mean and stdv stay 0 (the normalizer sets them); the ingest paths
    give the JAX package's reads (tests above and
    tests/test_torch_native.py)."""
    import warnings

    import numpy as np

    from deepmod_tpu.io.events import move_table_events as jax_events
    from deepmod_tpu_torch.io.events import move_table_events

    rng = np.random.RandomState(0)
    outcomes = set()
    for _ in range(400):
        nrow = rng.randint(0, 40)
        seq = "".join(rng.choice(list("ACGT"), nrow))
        moves = rng.choice([0, 1, 2], rng.randint(1, 60), p=[0.4, 0.5, 0.1])
        sig = rng.normal(0, 1, rng.randint(0, 2 * len(moves) + 20))
        first, stride = int(rng.randint(-2, 10)), int(rng.choice([2, 5]))
        got = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for name, fn in (("jax", jax_events), ("torch", move_table_events)):
                try:
                    got[name] = fn(moves, sig, seq, first, stride=stride)
                except (IndexError, OverflowError, ValueError) as exc:
                    got[name] = type(exc)
        if isinstance(got["jax"], type):
            outcomes.add(got["jax"])
            assert got["torch"] is ValueError
            continue
        outcomes.add("events")
        (want, want_skip), (events, skip) = got["jax"], got["torch"]
        assert skip == want_skip and len(events) == len(want)
        for field in ("start", "length", "model_state"):
            np.testing.assert_array_equal(events[field], want[field])
        assert not events["mean"].any() and not events["stdv"].any()
    assert outcomes == {"events", IndexError, OverflowError}
