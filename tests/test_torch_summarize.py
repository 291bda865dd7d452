"""``detect --predDet 0`` and ``--mod_cluster 1`` in the port against the
JAX package, on the CPU.

One synthetic fast5 dataset (a CG signal shift, so the predictions hold
runs of methylated CpGs for the rescue to act on) and one .npz model go
through the JAX ``detect_run`` (scan path) and the port's
``detect_run(device='cpu', precision='fp32')``. Every run writes to the
same out folder path in turn and is renamed away after, so the index
files' path headers match too. Tolerance: none, every BED is compared
byte for byte, and the rescue's arrays element for element.
"""

import dataclasses
import glob
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepmod_tpu.engine.detect import DetectConfig as JaxDetectConfig
from deepmod_tpu.engine.detect import detect_run as jax_detect_run
from deepmod_tpu.engine.summarize import (
    apply_mod_cluster_rescue as jax_rescue,
    summarize_run as jax_summarize_run,
)
from deepmod_tpu.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu.models.tf_import import save_bilstm_npz
from deepmod_tpu.testing.synthetic import SynthConfig, generate_dataset
from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run
from deepmod_tpu_torch.engine.summarize import apply_mod_cluster_rescue
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_into(root, name, fn, cfg):
    """Run detect into <root>/run, then move it to <root>/<name>."""
    res = fn(cfg)
    shutil.move(os.path.join(root, "run"), os.path.join(root, name))
    os.rename(os.path.join(root, "run.done"),
              os.path.join(root, name + ".done"))
    return res


def _beds(folder, prefix):
    out = {}
    for path in sorted(glob.glob(os.path.join(folder, f"{prefix}.*.bed"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_summarize"))
    generate_dataset(root, SynthConfig(
        genome_sizes={"chrS": 12000}, num_reads=8, read_length=(700, 1200),
        seed=17, mod_motif="CG", mod_level_shift=1.0,
    ))
    model_config = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(jax.random.PRNGKey(3), model_config)
    # larger LSTM kernels and an output layer whose calls depend on the
    # window: about 30% of the calls methylated, so the +-12-base
    # neighborhoods hold mixed CpGs
    for lane in ("fw", "bw"):
        for lp in params[lane]:
            lp["kernel"] = np.asarray(lp["kernel"]) * 6
    rng = np.random.RandomState(5)
    params["out_w"] = rng.normal(0, 1.0, (200, 2)).astype(np.float32)
    params["out_b"] = np.asarray([0.0, -6.0], np.float32)
    model = os.path.join(root, "model.npz")
    save_bilstm_npz(model, params, model_config)
    common = dict(
        wrk_base=os.path.join(root, "fast5"), ref=os.path.join(root, "ref.fa"),
        model_path=model, out_folder=os.path.join(root, "run"),
        file_id="mod", base="C", align_str="builtin",
    )
    jax_cfg = JaxDetectConfig(**common)
    torch_cfg = DetectConfig(**common, device="cpu", precision="fp32")
    res = {
        "torch": _run_into(root, "torch", detect_run, torch_cfg),
        "jax_mc": _run_into(root, "jax_mc", jax_detect_run,
                            dataclasses.replace(jax_cfg, mod_cluster=True)),
        "torch_mc": _run_into(root, "torch_mc", detect_run,
                              dataclasses.replace(torch_cfg,
                                                  mod_cluster=True)),
        "torch_mc_t2": _run_into(
            root, "torch_mc_t2", detect_run,
            dataclasses.replace(torch_cfg, mod_cluster=True, threads=2,
                                files_per_batch=2)),
    }
    return root, common, res


def test_rescue_flips_calls_in_this_dataset(runs):
    """The fixture exercises the rescue: its BEDs count more methylated
    calls than the plain run's, over the same coverage."""
    root, _, _ = runs
    plain = _beds(os.path.join(root, "torch"), "mod_pos")
    rescued = _beds(os.path.join(root, "torch_mc"), "cluster_mod_pos")
    assert plain and sorted(rescued) == ["cluster_" + k for k in sorted(plain)]

    def totals(beds):
        rows = [line.split() for b in beds.values()
                for line in b.decode().splitlines()]
        return sum(int(r[9]) for r in rows), sum(int(r[11]) for r in rows)

    cov_plain, mod_plain = totals(plain)
    cov_rescued, mod_rescued = totals(rescued)
    assert cov_rescued == cov_plain
    assert mod_plain > 0 and mod_rescued > mod_plain
    assert not _beds(os.path.join(root, "torch_mc"), "mod_pos")


@pytest.mark.parametrize("run", ["torch_mc", "torch_mc_t2"])
def test_mod_cluster_beds_match_jax(runs, run):
    """Inline --mod_cluster 1 (single process, and in the HostPool workers
    under --threads 2): cluster_mod_pos.* byte-identical to JAX's."""
    root, _, res = runs
    assert res[run].num_reads == res["jax_mc"].num_reads == 8
    want = _beds(os.path.join(root, "jax_mc"), "cluster_mod_pos")
    assert want and _beds(os.path.join(root, run), "cluster_mod_pos") == want
    assert [os.path.basename(p) for p in res[run].bed_files] == sorted(want)


@pytest.mark.parametrize("mod_cluster", [False, True])
def test_pred_det0_rebuilds_the_beds(runs, tmp_path, mod_cluster):
    """--predDet 0 over the port's per-read files: the BEDs of the full
    run (plain, or the inline --mod_cluster run) and of JAX's
    summarize_run over the same predetail and index files."""
    root, common, _ = runs
    pred_path = os.path.join(root, "torch", "mod")
    out = str(tmp_path / "sum")
    cfg = DetectConfig(**dict(common, out_folder=out), pred_det=False,
                       pred_path=pred_path, mod_cluster=mod_cluster)
    # no model is loaded and no device touched: the default device stays
    # cuda, which runs on a machine without a GPU too
    res = detect_run(cfg)
    assert res.num_reads == 0 and os.path.exists(out + ".done")
    prefix = "cluster_mod_pos" if mod_cluster else "mod_pos"
    got = _beds(out, prefix)
    full = "torch_mc" if mod_cluster else "torch"
    assert got and got == _beds(os.path.join(root, full), prefix)
    jax_out = str(tmp_path / "jax_sum")
    jax_summarize_run(pred_path, jax_out, "C", mod_cluster)
    assert _beds(jax_out, prefix) == got
    assert [os.path.basename(p) for p in res.bed_files] == sorted(got)


def test_pred_det0_through_the_cli(runs, tmp_path):
    root, _, _ = runs
    out = str(tmp_path / "cli_sum")
    proc = subprocess.run(
        [sys.executable, "-m", "deepmod_tpu_torch", "detect",
         "--predDet", "0", "--predpath", os.path.join(root, "torch", "mod"),
         "--outFolder", out, "--mod_cluster", "1", "--Base", "C"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "detect done: 0 reads" in proc.stdout
    want = _beds(os.path.join(root, "torch_mc"), "cluster_mod_pos")
    assert want and _beds(out, "cluster_mod_pos") == want


def _random_base_map(rng, n):
    bases = np.array(list("ACGTN-"))
    # CpG-rich with gaps and N breaks: 40% C/G pairs, a few N and '-'
    refbase = rng.choice(bases, n, p=[0.15, 0.3, 0.3, 0.15, 0.04, 0.06])
    out = np.zeros(n, dtype=[("refbase", "U1"), ("readbase", "U1"),
                             ("refbasei", np.uint64), ("readbasei", np.uint64),
                             ("mod_pred", np.int64)])
    out["refbase"] = refbase
    out["readbase"] = rng.choice(bases[:4], n)
    out["refbasei"] = np.arange(n)
    out["readbasei"] = np.arange(n)
    out["mod_pred"] = (rng.rand(n) < rng.uniform(0.3, 0.7)).astype(np.int64)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_rescue_matches_jax_on_random_base_maps(seed):
    rng = np.random.RandomState(seed)
    for n in (0, 1, 30, 400):
        m = _random_base_map(rng, n)
        want = jax_rescue(m.copy())
        got = apply_mod_cluster_rescue(m.copy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if n == 400:  # the rescue flipped some calls
            assert (got["mod_pred"] != m["mod_pred"]).any()
