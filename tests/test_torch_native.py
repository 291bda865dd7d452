"""The port's native host library (``deepmod_tpu_torch/native``) against its
numpy twins and against the JAX package's native library.

The library builds with g++ from the port's own sources at first use. Each
binding must give the same bits as the port's numpy twin (the host layers
with ``use_native(False)``) and as the JAX package's native function on
the same numpy-seeded inputs; the cases mirror ``tests/test_native.py``
and ``tests/test_native_fast5.py``, crafted move and gap patterns
included. Two first builds into one empty build directory, started
together, must both load a whole library.
"""

import contextlib
import dataclasses
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import deepmod_tpu.native.fast5_native as jf5
import deepmod_tpu.native.lib as jl
from deepmod_tpu_torch.io.events import EVENT_DTYPE
from deepmod_tpu_torch.io.signal_norm import (
    SignalRangeError,
    event_mean_std,
    normalize_and_event_stats,
    normalize_signal,
)
from deepmod_tpu_torch.native import fast5_native as tf5
from deepmod_tpu_torch.native import lib as tl
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def numpy_twins():
    """The port's host layers on their numpy twins."""
    tl.use_native(False)
    try:
        yield
    finally:
        tl.use_native(True)


def _equal(*arrays):
    for other in arrays[1:]:
        np.testing.assert_array_equal(other, arrays[0])


def test_library_builds_from_the_port_sources():
    assert tl.native_available(), tl.build_info
    path = tl.build_info["path"]
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.isfile(path)
    assert all(tl.loaded_functions().values()), tl.loaded_functions()
    # no binary is checked in beside the sources
    native_dir = os.path.join(REPO, "deepmod_tpu_torch", "native")
    assert not [f for f in os.listdir(native_dir) if f.endswith(".so")]
    assert tf5.native_fast5_available()
    with numpy_twins():
        assert not tl.native_available()
        assert not tf5.native_fast5_available()
    assert tl.native_available()


def test_concurrent_first_builds_both_load(tmp_path):
    """Two processes meet at a barrier, then both find no library and
    compile it into the same directory at once."""
    code = (
        "import glob, os, sys, time\n"
        "from deepmod_tpu_torch.native import lib\n"
        "open(sys.argv[1] + sys.argv[2], 'w').close()\n"
        "t0 = time.time()\n"
        "while len(glob.glob(sys.argv[1] + '*')) < 2 and "
        "time.time() - t0 < 120:\n"
        "    time.sleep(0.01)\n"
        "assert lib.native_available(), lib.build_info\n"
        "assert not lib.build_info['cached']\n"
        "print(lib.minimizers_native('ACGT' * 50, 15, 10)[0].tolist())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO,
               DMT_NATIVE_BUILD_DIR=str(tmp_path / "native"))
    ready = str(tmp_path / "ready")
    procs = [subprocess.Popen([sys.executable, "-c", code, ready, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    libs = [f for _, _, files in os.walk(tmp_path / "native") for f in files]
    assert libs == [tl.LIB_NAME], libs  # no temporary left behind


def _events(rng, n, span, lengths):
    m_event = np.zeros(n, EVENT_DTYPE)
    m_event["start"] = np.sort(rng.choice(span, n, replace=False))
    m_event["length"] = rng.randint(*lengths, n)
    return m_event


def test_event_stats_matches_numpy_and_jax():
    rng = np.random.RandomState(0)
    raw = np.round(rng.normal(0, 1.2, 5000), 3)
    m_event = _events(rng, 200, 4900, (3, 15))
    want, n_want = event_mean_std(m_event.copy(), raw)
    got = tl.event_stats_native(raw, m_event["start"], m_event["length"])
    jax = jl.event_stats_native(raw, m_event["start"], m_event["length"])
    assert got[2] == jax[2] == n_want
    _equal(want["mean"], got[0], jax[0])
    _equal(want["stdv"], got[1], jax[1])


def test_event_stats_stdv_half_milli_tie():
    raw = np.asarray([0.100, 0.105] * 8, np.float64)
    m_event = np.zeros(8, EVENT_DTYPE)
    m_event["start"] = np.arange(8) * 2
    m_event["length"] = 2
    want, n_want = event_mean_std(m_event.copy(), raw)
    got = tl.event_stats_native(raw, m_event["start"], m_event["length"])
    jax = jl.event_stats_native(raw, m_event["start"], m_event["length"])
    assert got[2] == jax[2] == n_want
    _equal(want["mean"], got[0], jax[0])
    _equal(want["stdv"], got[1], jax[1])


def _normalize_all(raw, lo, hi):
    with numpy_twins():
        want = normalize_signal(raw.copy(), lo, hi)
    return (want, tl.normalize_signal_native(raw.copy(), lo, hi),
            jl.normalize_signal_native(raw.copy(), lo, hi),
            normalize_signal(raw.copy(), lo, hi))


@pytest.mark.parametrize("span", [(50, 7900), (50, 7901)])  # even, odd
def test_normalize_matches_numpy_and_jax(span):
    raw = np.random.RandomState(1).normal(480, 35, 8000)
    _equal(*_normalize_all(raw, *span))


def _fused_case(raw, m_event, span_start, span_end):
    with numpy_twins():
        want_sig = normalize_signal(raw, span_start, span_end)
        want_ev, n_want = event_mean_std(m_event.copy(), want_sig)
        sig0, ev0, n0 = normalize_and_event_stats(
            m_event.copy(), raw, span_start, span_end)
    assert n0 == n_want
    _equal(want_sig, sig0)
    _equal(want_ev["mean"], ev0["mean"])
    for fn in (tl.normalize_event_stats_native,
               jl.normalize_event_stats_native):
        sig, means, stds, n = fn(raw, span_start, span_end,
                                 m_event["start"], m_event["length"])
        assert n == n_want
        _equal(want_sig, sig)
        _equal(want_ev["mean"], means[:n])
        _equal(want_ev["stdv"], stds[:n])
    # the dispatcher, on the native path
    sig2, ev2, n2 = normalize_and_event_stats(
        m_event.copy(), raw, span_start, span_end)
    assert n2 == n_want
    _equal(want_sig, sig2)
    _equal(want_ev["mean"], ev2["mean"])
    _equal(want_ev["stdv"], ev2["stdv"])


def test_fused_normalize_event_stats_matches_two_step():
    rng = np.random.RandomState(7)
    raw = rng.normal(480, 35, 9000)
    m_event = _events(rng, 300, np.arange(40, 8800), (3, 15))
    starts = m_event["start"]
    _fused_case(raw, m_event, int(starts[0]),
                int(starts[-1] + m_event["length"][-1]))


@pytest.mark.parametrize("span", [(50, 8551), (50, 8550)])  # odd, even
def test_normalize_integer_fast_path_matches_numpy(span):
    raw = np.random.RandomState(9).randint(120, 900, 9000).astype(np.float64)
    _equal(*_normalize_all(raw, *span))


@pytest.mark.parametrize("n_span", [701, 700])  # odd, even
def test_fused_integer_fast_path_matches_two_step(n_span):
    rng = np.random.RandomState(10)
    raw = rng.randint(-200, 1200, 4000).astype(np.float64)
    m_event = _events(rng, 100, np.arange(100, 100 + n_span - 20), (2, 12))
    _fused_case(raw, m_event, 100, 100 + n_span)


def test_normalize_native_adversarial_edges():
    """Degenerate and hostile spans: every fast-path guard (histogram
    reject, TwoSum inexactness, zero scale) lands on a path that gives the
    JAX package's native bits and the numpy twin's (NaNs compared
    positionally), with one known exception. A two-valued span whose MAD
    is 0 (more than half the samples equal the median) scales to NaN and
    +-inf; the numpy twin's second median then sees a NaN and turns the
    whole read NaN, while the C++ core (the JAX package's, kept as it is)
    leaves the infinities. That divergence is pinned here as it stands."""
    rng = np.random.RandomState(3)
    two_valued = np.where(rng.rand(1001) < 0.5, 3.0, 4.0)
    cases = [
        np.full(1000, 7.0),                       # scale 0 -> NaN path
        two_valued,                               # MAD 0, both sides
        rng.randint(10**7, 10**7 + 30, 999).astype(np.float64),
        np.concatenate(                           # histogram-width reject
            [[0.0], [3e6], rng.randint(100, 200, 998).astype(np.float64)]
        ),
        rng.normal(0, 1e-300, 1000),              # denormal-ish floats
        np.concatenate(                           # TwoSum-inexact midpoints
            [rng.normal(1e9, 1, 500), rng.normal(1e-9, 1e-12, 500)]
        ),
        rng.randint(-500, -100, 777).astype(np.float64),
        np.asarray([5.0, 6.0, 7.0]),              # tiny span
    ]
    with np.errstate(divide="ignore", invalid="ignore"):
        for raw in cases:
            raw = np.asarray(raw, np.float64)
            for span in [(0, len(raw)), (0, len(raw) - 1), (1, len(raw))]:
                want, got, jax, dispatched = _normalize_all(raw, *span)
                _equal(jax, got, dispatched)
                if raw is two_valued:
                    assert np.isnan(want).all()
                    assert np.isinf(got).any() and not np.isnan(got).all()
                    continue
                both_nan = np.isnan(want) & np.isnan(got)
                _equal(want[~both_nan], got[~both_nan])


def test_fused_normalize_event_stats_truncation_and_reject():
    rng = np.random.RandomState(8)
    raw = rng.normal(480, 35, 4000)
    m_event = np.zeros(600, EVENT_DTYPE)
    m_event["start"] = np.arange(600) * 6
    m_event["length"] = 6
    m_event["length"][550] = 0  # empty slice past index 500 -> truncate
    _, ev, n = normalize_and_event_stats(m_event.copy(), raw.copy(), 0, 3600)
    with numpy_twins():
        _, ev0, n0 = normalize_and_event_stats(
            m_event.copy(), raw.copy(), 0, 3600)
    assert n == n0 == 549 and len(ev) == 549
    _equal(ev0["mean"], ev["mean"])

    m_event["length"][550] = 6
    m_event["length"][10] = 0  # empty slice at index <= 500 -> reject
    with pytest.raises(SignalRangeError):
        normalize_and_event_stats(m_event.copy(), raw.copy(), 0, 3600)
    with numpy_twins(), pytest.raises(SignalRangeError):
        normalize_and_event_stats(m_event.copy(), raw.copy(), 0, 3600)


def test_global_align_matches_numpy_and_jax():
    from deepmod_tpu_torch.align import dp

    rng = np.random.RandomState(2)
    bases = np.array(list("ACGT"))
    for _ in range(30):
        a = "".join(rng.choice(bases, rng.randint(0, 40)))
        b = "".join(rng.choice(bases, rng.randint(0, 40)))
        with numpy_twins():
            want = dp.global_align_ops(a, b)
        assert tl.global_align_ops_native(a, b) == want, (a, b)
        assert jl.global_align_ops_native(a, b) == want, (a, b)
        assert dp.global_align_ops(a, b) == want


def test_minimizers_match_numpy_and_jax():
    from deepmod_tpu_torch.align import minimizer as mz

    rng = np.random.RandomState(3)
    seq = "".join(rng.choice(list("ACGT"), 5000))
    seq = seq[:1000] + "N" * 7 + seq[1000:]  # N handling
    with numpy_twins():
        want = mz._minimizers(seq, 15, 10)
    for got in (tl.minimizers_native(seq, 15, 10),
                jl.minimizers_native(seq, 15, 10), mz._minimizers(seq, 15, 10)):
        _equal(want[0], got[0])
        _equal(want[1], got[1])


def test_format_matrix_f3_matches_savetxt_and_jax():
    rng = np.random.RandomState(6)
    adversarial = np.asarray([
        0.0, -0.0, -0.0004, 0.0004, 0.0005, -0.0005, 0.0015, -0.0015,
        1.0005, 2.0005, -1.0005, 123456789.0, -123456789.0,
        1e15, -1e15, 1.23e16, 0.123, -0.123, 999.9995, -999.9995,
    ])
    mats = [
        np.round(rng.normal(0, 3, (40, 5)), 3),
        rng.normal(0, 3, (40, 5)),
        np.concatenate([adversarial, rng.normal(0, 1, 20)]).reshape(8, 5),
        np.arange(30, dtype=np.float64).reshape(6, 5) * 2**22,
    ]
    for m in mats:
        sio = io.StringIO()
        np.savetxt(sio, m, fmt="%.3f")
        got = bytes(tl.format_matrix_f3_native(m))
        assert got.decode() == sio.getvalue()
        assert got == bytes(jl.format_matrix_f3_native(m))


def test_write_xy_gz_matches_savetxt(tmp_path):
    from deepmod_tpu_torch.engine.getfeatures import _FeatureFlusher

    rng = np.random.RandomState(7)
    feat = np.round(rng.normal(0, 2, (500, 10)), 3)
    feat[:, 0] = np.arange(500) + 2**25
    _FeatureFlusher._write_xy_gz(str(tmp_path / "a.xy.gz"), feat)
    with numpy_twins():
        _FeatureFlusher._write_xy_gz(str(tmp_path / "b.xy.gz"), feat)
    np.savetxt(str(tmp_path / "c.xy.gz"), feat, fmt="%.3f")
    texts = []
    for name in "abc":
        with gzip.open(tmp_path / f"{name}.xy.gz") as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1] == texts[2]


def test_hash_index_matches_searchsorted_and_jax():
    from deepmod_tpu_torch.align.minimizer import MinimizerIndex

    rng = np.random.RandomState(5)
    genome = {
        "a": "".join(rng.choice(list("ACGT"), 30000)),
        "b": "".join(rng.choice(list("ACGT"), 12000)),
    }
    idx = MinimizerIndex(genome, max_hits=3)
    assert idx._table is not None
    queries = np.concatenate([
        idx._hashes[rng.randint(0, len(idx._hashes), 500)],  # present
        rng.randint(0, 2**63, 200).astype(np.uint64),        # mostly absent
    ])
    got = idx.lookup(queries)
    jax_q, jax_src = jl.HashIndexNative(idx._hashes).lookup(queries, 3)
    port_q, port_src = tl.HashIndexNative(idx._hashes).lookup(queries, 3)
    _equal(jax_q, port_q)
    _equal(jax_src, port_src)
    idx._table = None  # the searchsorted twin
    want = idx.lookup(queries)
    for g, w in zip(got, want):
        _equal(w, g)


def test_native_aligner_end_to_end():
    """The aligner gives the same records on the native core, on the numpy
    twins and in the JAX package."""
    from deepmod_tpu.align.aligner import MinimizerAligner as JaxAligner
    from deepmod_tpu_torch.align.aligner import MinimizerAligner

    rng = np.random.RandomState(4)
    genome = {"chrN": "".join(rng.choice(list("ACGT"), 20000))}
    read = genome["chrN"][7000:8500]
    mutated = read[:300] + "A" + read[301:900] + read[905:]
    reads = {"r": read, "m": mutated}
    recs = MinimizerAligner(genome).align(reads)
    assert len(recs) == 2 and abs(recs[1].pos - 1 - 7000) <= 64
    with numpy_twins():
        want = MinimizerAligner(genome).align(reads)
    jax = JaxAligner(genome).align(reads)

    def fields(records):
        return [(r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq,
                 [np.asarray(a).tolist() for a in r.cigar_arrays or ()])
                for r in records]

    assert fields(recs) == fields(want) == fields(jax)


def test_native_chain_band_matches_python_and_jax():
    import deepmod_tpu_torch.align.minimizer as mz

    rng = np.random.RandomState(11)
    for trial in range(40):
        n = rng.randint(1, 60)
        qpos = rng.randint(0, 3000, n).astype(np.int64)
        rpos = rng.randint(0, 3000, n).astype(np.int64)
        rid = np.zeros(n, np.int64)
        keep_q, keep_r, second = tl.chain_band_native(qpos, rpos, 500)
        jq, jr, js = jl.chain_band_native(qpos, rpos, 500)
        _equal(jq, keep_q)
        _equal(jr, keep_r)
        assert js == second
        with numpy_twins():
            chain = mz._best_chain(qpos, rid, rpos, "+")
        if chain is None:
            assert len(keep_q) == 0
            continue
        _equal(chain.anchors_q, keep_q)
        _equal(chain.anchors_r, keep_r)
        assert second == chain.second_score, trial


def test_native_align_multi_matches_per_segment():
    from deepmod_tpu_torch.align.dp import global_align_ops

    rng = np.random.RandomState(3)
    q = "".join(rng.choice(list("ACGT"), 800))
    r = "".join(rng.choice(list("ACGT"), 1200))
    segs = []
    for _ in range(25):
        qs = rng.randint(0, 700)
        rs = rng.randint(0, 1100)
        segs.append((qs, qs + rng.randint(0, 90), rs, rs + rng.randint(0, 90)))
    segs = np.asarray(segs, np.int64)
    got = tl.global_align_multi_native(q.encode(), r.encode(), segs)
    assert got == jl.global_align_multi_native(q.encode(), r.encode(), segs)
    with numpy_twins():
        for (qs, qe, rs, re), ops in zip(segs, got):
            assert ops == global_align_ops(q[qs:qe], r[rs:re])


def test_cpg_swap_matches_python_and_jax():
    from deepmod_tpu_torch.align.cigar import _cpg_swap

    rng = np.random.RandomState(12)
    alphabet = np.frombuffer(b"ACGT-", np.uint8)
    swapped = 0
    for _ in range(20):
        # CpG-rich references, reads with dense deletions beside them
        ref = rng.choice(alphabet[:4], 400, p=[0.1, 0.4, 0.4, 0.1])
        read = ref.copy()
        read[rng.rand(400) < 0.25] = alphabet[4]
        want = read.copy()
        with numpy_twins():
            _cpg_swap(ref, want)
        swapped += int((want != read).any())
        got, jax = read.copy(), read.copy()
        assert tl.cpg_swap_native(ref, got)
        assert jl.cpg_swap_native(ref, jax)
        _equal(want, got, jax)
    assert swapped > 10


# -- the fast5 reader (dlopen'd libhdf5) -----------------------------------

def _dataset(tmp_path, tag, **kw):
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        generate_dataset,
    )

    return generate_dataset(str(tmp_path / tag), SynthConfig(**kw))[1]


def _assert_same_read(a, b, msg=""):
    assert a.read_id == b.read_id, msg
    assert a.basecall == b.basecall, msg
    assert a.albacore_version == b.albacore_version, msg
    assert tuple(a.left_right_skip) == tuple(b.left_right_skip), msg
    assert len(a.m_event) == len(b.m_event), msg
    for field in a.m_event.dtype.names:
        _equal(a.m_event[field], b.m_event[field])
    _equal(a.raw_signals, b.raw_signals)


def _three_readers(path, opts):
    """(numpy twins over h5py, the port's native reader, the JAX
    package's native reader) for one file."""
    from deepmod_tpu.io.fast5 import Fast5ReadOptions as JaxOptions
    from deepmod_tpu_torch.io.fast5 import read_fast5_file

    with numpy_twins():
        want = read_fast5_file(path, opts)
    got = tf5.read_fast5_native(path, opts)
    jax = jf5.read_fast5_native(path, JaxOptions(**dataclasses.asdict(opts)))
    return want, got, jax


@pytest.mark.parametrize("style,move_opt", [("v2", False), ("v1", False),
                                            ("move", True)])
def test_native_reader_identical(tmp_path, style, move_opt):
    from deepmod_tpu_torch.io.fast5 import Fast5ReadOptions

    reads = _dataset(tmp_path, style, genome_sizes={"chrN": 8000},
                     num_reads=2, read_length=(500, 800), seed=29,
                     fast5_style=style)
    for sim in reads:
        want, got, jax = _three_readers(sim.path,
                                        Fast5ReadOptions(move=move_opt))
        _assert_same_read(want, got, style)
        _assert_same_read(jax, got, style)


def test_native_batch_env_flag(tmp_path, monkeypatch):
    from deepmod_tpu_torch.io.fast5 import read_fast5_batch

    reads = _dataset(tmp_path, "env", genome_sizes={"chrN": 6000},
                     num_reads=2, read_length=(400, 600), seed=31)
    paths = [r.path for r in reads]
    native = read_fast5_batch(paths)
    monkeypatch.setenv("DMT_NATIVE_FAST5", "0")
    h5py_path = read_fast5_batch(paths)
    with numpy_twins():
        plain = read_fast5_batch(paths)
    assert set(plain) == set(native) == set(h5py_path)
    for rid in plain:
        _assert_same_read(plain[rid], native[rid])
        _assert_same_read(plain[rid], h5py_path[rid])


def _rewrite_events(path, edit):
    import h5py

    key = "Analyses/Basecall_1D_000/BaseCalled_template/Events"
    with h5py.File(path, "r+") as fh:
        ev = fh[key][()]
        edit(fh, ev)
        del fh[key]
        fh.create_dataset(key, data=ev)


def test_native_collapse_crafted_moves(tmp_path):
    """The C v2 collapse on move patterns the synthetic generator never
    emits: leading stays, long stay runs, move values > 1."""
    from deepmod_tpu_torch.io.fast5 import Fast5ReadOptions

    reads = _dataset(tmp_path, "crafted", genome_sizes={"chrN": 8000},
                     num_reads=3, read_length=(500, 800), seed=41,
                     fast5_style="v2")
    rng = np.random.RandomState(7)
    for sim, pattern in zip(reads, ["leading_stays", "long_runs",
                                    "multi_moves"]):
        def edit(fh, ev, pattern=pattern):
            move = ev["move"].copy()
            if pattern == "leading_stays":
                move[:5] = 0
            elif pattern == "long_runs":
                mid = len(move) // 2
                move[mid : mid + 30] = 0
            else:
                hits = rng.rand(len(move)) < 0.2
                move[hits] = rng.randint(2, 5, hits.sum())
                move[0] = 0
            ev["move"] = move

        _rewrite_events(sim.path, edit)
        want, got, jax = _three_readers(sim.path, Fast5ReadOptions())
        _assert_same_read(want, got, pattern)
        _assert_same_read(jax, got, pattern)


def test_native_collapse_v1_crafted_gaps(tmp_path):
    """The C v1 collapse on gap patterns the synthetic generator never
    emits: >2-sample gaps (filler pseudo-event), 1-2 sample gaps
    (length-merged), negative gaps (overlap), stay runs."""
    from deepmod_tpu_torch.io.fast5 import Fast5ReadOptions

    reads = _dataset(tmp_path, "v1crafted", genome_sizes={"chrN": 8000},
                     num_reads=2, read_length=(500, 800), seed=43,
                     fast5_style="v1")
    rng = np.random.RandomState(9)

    def edit(fh, ev):
        rate = fh["UniqueGlobalKey/channel_id"].attrs["sampling_rate"]
        start = ev["start"].copy()
        n = len(start)
        bumped = [(n // 4, 8.0), (n // 2, 1.5), (3 * n // 4, 2.4)]
        for idx, bump in bumped:
            start[idx] = start[idx] + bump / float(rate)
        ev["start"] = start
        mv = ev["move"].copy()
        stays = rng.rand(n) < 0.3
        stays[0] = stays[-1] = False
        mv[stays] = 0
        for idx, _ in bumped:
            mv[idx] = 1  # bumped events must be leaders
        ev["move"] = mv

    for sim in reads:
        _rewrite_events(sim.path, edit)
        want, got, jax = _three_readers(sim.path, Fast5ReadOptions())
        _assert_same_read(want, got)
        _assert_same_read(jax, got)
