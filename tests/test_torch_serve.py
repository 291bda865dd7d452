"""The port's serving mode on the CPU at fp32: the cases of
tests/test_serve.py against ``deepmod_tpu_torch.serve``, its answers
against the JAX ``DetectService``'s on the same dataset and weights (reads
and positions equal), the coalescer's capped grace window (the one
recorded deviation), and the latency probe."""

import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deepmod_tpu.serve import DetectService as JaxDetectService
from deepmod_tpu_torch import serve as tserve
from deepmod_tpu_torch.cli import build_parser
from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
from deepmod_tpu_torch.serve import DetectService, _DeviceCoalescer, serve
from deepmod_tpu_torch.testing import tf_bundle
from deepmod_tpu_torch.testing.synthetic import (
    SynthConfig,
    generate_dataset,
    write_move_dataset_pod5,
)
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 16


def _model(folder):
    cfg = BiLSTMConfig(num_hidden=HIDDEN)
    params = init_bilstm_params(0, cfg, device="cpu")
    path = os.path.join(folder, "m.npz")
    save_bilstm_npz(path, params, cfg)
    tf_bundle.write_reference_bilstm(os.path.join(folder, "mod_train"), params)
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve"))
    _, reads = generate_dataset(out, SynthConfig(
        genome_sizes={"chrV": 12000}, num_reads=3, read_length=(600, 900),
        seed=41))
    return out, [r.path for r in reads], _model(out)


@pytest.fixture(scope="module")
def server(dataset):
    out, paths, _ = dataset
    # the model as the reference's TF1 checkpoint
    httpd = serve(os.path.join(out, "ref.fa"), os.path.join(out, "mod_train"),
                  port=0, precision="fp32", device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", paths
    httpd.shutdown()
    httpd.server_close()
    httpd.dmt_service.close()
    thread.join(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _service(dataset, **kw):
    out, _, model = dataset
    return DetectService(os.path.join(out, "ref.fa"), model,
                         align_str="builtin", precision="fp32", device="cpu",
                         **kw)


def test_healthz(server):
    base_url, _ = server
    status, body = _get(base_url + "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["backend"] == "cpu" and body["device"] == "cpu"
    assert body["model"].endswith("mod_train")


def test_detect_roundtrip(server, dataset):
    base_url, paths = server
    status, body = _post(base_url + "/detect", {"fast5": paths})
    assert status == 200
    assert len(body["reads"]) == len(paths)
    for entry in body["reads"]:
        assert entry["chrom"] == "chrV" and entry["n_aligned"] > 0
    assert body["positions"] and body["positions"] == sorted(body["positions"])
    chrom, strand, pos, cov, mod = body["positions"][0]
    assert chrom == "chrV" and strand in "+-" and cov >= 1 and 0 <= mod <= cov
    # the HTTP answer (TF prefix) is the in-process one (.npz)
    svc = _service(dataset)
    try:
        assert json.loads(json.dumps(svc.detect(paths))) == body
    finally:
        svc.close()
    status2, body2 = _post(base_url + "/detect", {"fast5": [paths[0]]})
    assert status2 == 200 and len(body2["reads"]) == 1


def test_detect_bad_requests(server):
    base_url, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base_url + "/detect", {"fast5": []})
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base_url + "/nope", {})
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base_url + "/nope")
    assert err.value.code == 404
    status, body = _post(base_url + "/detect", {"fast5": ["/no/such.fast5"]})
    assert status == 200 and body["reads"] == [] and body["errors"]


def test_detect_with_host_pool(dataset):
    """threads>1 runs the host stage in a persistent HostPool; answers equal
    the in-process route's, and the pool's workers persist."""
    _, paths, _ = dataset
    svc1 = _service(dataset)
    svc2 = _service(dataset, threads=2)
    try:
        r1 = svc1.detect(paths)
        r2 = svc2.detect(paths)
        key = lambda e: e["read_id"]  # noqa: E731
        assert sorted(r1["reads"], key=key) == sorted(r2["reads"], key=key)
        assert r1["positions"] == r2["positions"]
        pids = [p.pid for p in svc2._pool._procs]
        r3 = svc2.detect(paths[:1])
        assert [p.pid for p in svc2._pool._procs] == pids
        assert len(r3["reads"]) == 1
    finally:
        svc1.close()
        svc2.close()


def test_concurrent_requests_coalesce(dataset):
    """Concurrent requests get the serial answers, in fewer device calls."""
    _, paths, _ = dataset
    svc = _service(dataset)
    predictor = svc.predictor
    orig = predictor.predict_from_blocks
    try:
        serial = {p: svc.detect([p]) for p in paths}
        calls = []

        def counting(*a, **k):
            calls.append(int(sum(a[2])))  # windows asked
            return orig(*a, **k)

        predictor.predict_from_blocks = counting
        calls0 = svc._coalescer.device_calls
        results, errs = {}, []

        def hit(p):
            try:
                results.setdefault(p, []).append(svc.detect([p]))
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        threads = [threading.Thread(target=hit, args=(p,)) for p in paths * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs and not any(t.is_alive() for t in threads)
        for p in paths:
            assert results[p] == [serial[p], serial[p]]
        assert 1 <= len(calls) < len(threads), calls
        assert svc._coalescer.device_calls - calls0 == len(calls)
    finally:
        predictor.predict_from_blocks = orig
        svc.close()


class _FakeResult:
    def __init__(self, n_aligned, tag=0):
        self.n_aligned = n_aligned
        self.tag = tag


def test_coalescer_delivers_errors_to_all_waiters():
    """A failing device call reaches every waiting request, and the
    dispatcher survives it."""
    def boom(results):
        raise RuntimeError("boom")

    coal = _DeviceCoalescer(boom)
    try:
        backs = []
        for _ in range(3):
            b = queue.Queue()
            coal._q.put(([_FakeResult(3)], b))
            backs.append(b)
        for b in backs:
            out = b.get(timeout=10)
            assert isinstance(out, RuntimeError) and "boom" in str(out)
        with pytest.raises(RuntimeError, match="boom"):
            coal.classify([_FakeResult(2)])
        out = coal.classify([])  # an empty request needs no device call
        assert isinstance(out, np.ndarray) and len(out) == 0
    finally:
        coal.close()
    assert not coal._thread.is_alive()


def test_coalescer_grace_is_capped_under_a_steady_stream():
    """The recorded deviation: requests arriving every 1 ms for 50 ms.
    The JAX coalescer restarts its 4 ms wait on every arrival, so it
    would hold all of them in one batch; here no batch takes a request
    more than COALESCE_GRACE_S after taking its first, and every request
    gets its own predictions back."""
    batches = []

    def predict(results):
        batches.append([r.tag for r in results])
        return np.concatenate([np.full(r.n_aligned, r.tag, np.int8)
                               for r in results])

    coal = _DeviceCoalescer(predict)
    backs = []
    try:
        t_end = time.monotonic() + 0.050
        tag = 0
        while time.monotonic() < t_end:
            b = queue.Queue()
            coal._q.put(([_FakeResult(2, tag % 100)], b))
            backs.append((tag % 100, b))
            tag += 1
            time.sleep(0.001)
        for t, b in backs:
            out = b.get(timeout=10)
            assert out.tolist() == [t, t]
    finally:
        coal.close()
    assert sum(len(b) for b in batches) == len(backs)
    assert coal.device_calls == len(batches)
    assert 0 < coal.max_grace_s <= tserve.COALESCE_GRACE_S
    # a 50 ms stream cannot fit in one capped batch
    assert len(batches) >= 2, batches


def test_single_flight_switch(monkeypatch):
    """DMT_SERVE_COALESCE=0: one device call a request."""
    monkeypatch.setenv("DMT_SERVE_COALESCE", "0")
    coal = _DeviceCoalescer(
        lambda results: np.zeros(sum(r.n_aligned for r in results), np.int8))
    try:
        backs = []
        for _ in range(5):
            b = queue.Queue()
            coal._q.put(([_FakeResult(1)], b))
            backs.append(b)
        for b in backs:
            assert len(b.get(timeout=10)) == 1
    finally:
        coal.close()
    assert coal.device_calls == 5


@pytest.fixture(scope="module")
def pod5_dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_pod5"))
    _, reads, _ = write_move_dataset_pod5(out, SynthConfig(
        genome_sizes={"chrV": 9000}, num_reads=8, read_length=(500, 800),
        seed=43, fast5_style="move"), n_files=8)
    return out, reads, _model(out)


def test_serve_pod5_requests(pod5_dataset):
    """A service built with --basecalls answers .pod5 request paths."""
    out, reads, model = pod5_dataset
    svc = DetectService(os.path.join(out, "ref.fa"), model,
                        align_str="builtin", precision="fp32", device="cpu",
                        basecalls=os.path.join(out, "calls.bam"))
    try:
        res = svc.detect(sorted({r.path for r in reads}))
        assert len(res["reads"]) == len(reads)
        assert res["positions"] and not res["errors"]
        assert sum(r["n_aligned"] for r in res["reads"]) > 0
    finally:
        svc.close()


@pytest.mark.parametrize("route", ["fast5", "pod5"])
def test_answers_equal_the_jax_service(dataset, pod5_dataset, route):
    """The same dataset and weights through the JAX DetectService and the
    port's, fp32 on the CPU: the same reads and positions."""
    if route == "fast5":
        out, paths, model = dataset
        basecalls = ""
    else:
        out, reads, model = pod5_dataset
        paths = sorted({r.path for r in reads})
        basecalls = os.path.join(out, "calls.bam")
    ref = os.path.join(out, "ref.fa")
    jsvc = JaxDetectService(ref, model, align_str="builtin",
                            precision="fp32", basecalls=basecalls)
    tsvc = DetectService(ref, model, align_str="builtin", precision="fp32",
                         device="cpu", basecalls=basecalls)
    try:
        want = jsvc.detect(paths)
        got = tsvc.detect(paths)
    finally:
        jsvc.close()
        tsvc.close()
    assert want["reads"] and got["reads"] == want["reads"]
    assert got["positions"] == want["positions"]
    assert got["errors"] == want["errors"]


def test_latency_probe_prints_its_table(pod5_dataset, capsys):
    from deepmod_tpu_torch.tools import probe_serve_latency as probe

    out, _, model = pod5_dataset
    assert probe.main(["--dataset", out, "--modfile",
                       os.path.join(out, "mod_train"), "--requests", "2",
                       "--device", "cpu", "--precision", "fp32"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "nvidia-smi" in lines[0]
    summary = json.loads(lines[-1])
    assert summary["backend"] == "cpu"
    assert [r["files_per_request"] for r in summary["rows"]] == [1, 8]
    assert summary["rows"][1]["reads_per_request"] == 8
    for row in summary["rows"]:
        assert row["p50_ms"] <= row["p95_ms"]
        assert row["device_calls_per_request"] == 1.0
    conc = {(r["concurrent_clients"], r["coalesce"]): r
            for r in summary["concurrent"]}
    assert sorted(conc) == [(c, on) for c in (1, 4, 8) for on in (False, True)]
    for (clients, on), row in conc.items():
        if not on or clients == 1:
            assert row["device_calls_per_request"] == 1.0
        else:
            assert 0 < row["device_calls_per_request"] <= 1.0
    assert os.environ.get("DMT_SERVE_COALESCE") is None


def test_serve_command_flags():
    args = build_parser().parse_args([
        "serve", "--Ref", "r.fa", "--modfile", "prefix", "--port", "0",
        "--precision", "fp32", "--threads", "2", "--basecalls", "c.bam",
        "--device", "cpu"])
    assert (args.Ref, args.modfile, args.port, args.precision, args.threads,
            args.basecalls, args.device) == (
        "r.fa", "prefix", 0, "fp32", 2, "c.bam", "cpu")
    assert build_parser().parse_args(
        ["serve", "--Ref", "r", "--modfile", "m"]).device == "cuda"


def test_serve_modules_load_no_torch():
    """A HostPool worker may import the serving modules: they load no
    torch until a service is built."""
    code = ("import sys\n"
            "import deepmod_tpu_torch.serve\n"
            "import deepmod_tpu_torch.tools.probe_serve_latency\n"
            "print('torch' in sys.modules)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
