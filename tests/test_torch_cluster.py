"""The cluster second stage in the port against the JAX package, on the
CPU: the MLP, its trainer, ``clusterpred`` / ``clustertrain``, and the
pod5 cohort with a methylation landscape that the loop runs on.

Tolerances, as stated at each check: the golden parity rtol 1e-5 / atol
1e-6 (tests/test_cluster_mlp.py); the forward against JAX's 1e-6; five
Adam steps against an optax step built here, rel 1e-5; the features
bit for bit; rewritten BED percentages equal except where p*100 lies
within 1e-4 of an integer (the two packages' fp32 rounding may fall on
either side).
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmod_tpu.models.cluster_mlp import (
    ClusterMLPConfig as JaxClusterConfig,
    cluster_forward as jax_forward,
    init_cluster_params as jax_init,
)
from deepmod_tpu.tools.cluster_predict import (
    build_cluster_features as jax_features,
    cluster_predict_run as jax_cluster_predict_run,
    load_cluster_model as jax_load_cluster_model,
)
from deepmod_tpu.train.cluster_trainer import save_cluster_npz as jax_save
from deepmod_tpu_torch import cli as torch_cli
from deepmod_tpu_torch.models.cluster_mlp import (
    ClusterMLPConfig,
    _dropout,
    cluster_forward,
    cluster_params_from_numpy,
    cluster_params_to_numpy,
    init_cluster_params,
)
from deepmod_tpu_torch.testing.threads import one_thread  # noqa: F401
from deepmod_tpu_torch.tools.cluster_predict import (
    build_cluster_features,
    cluster_predict_run,
    load_cluster_model,
)
from deepmod_tpu_torch.train.cluster_trainer import (
    ClusterTrainConfig,
    cluster_loss,
    save_cluster_npz,
    train_cluster_model,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _golden():
    data = np.load(os.path.join(GOLDEN, "cluster_weights.npz"))
    return {k: data[k] for k in data.files}


def _np(t):
    return t.detach().cpu().numpy()


def test_golden_parity_with_tf_checkpoint():
    params = cluster_params_from_numpy(_golden(), "cpu")
    x = np.load(os.path.join(GOLDEN, "cluster_parity_x.npy"))
    want = np.load(os.path.join(GOLDEN, "cluster_parity_y.npy")).ravel()
    got = _np(cluster_forward(params, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_forward_matches_jax(seed):
    jparams = jax_init(jax.random.PRNGKey(seed), JaxClusterConfig())
    x = np.random.RandomState(seed).rand(257, 14).astype(np.float32)
    x[:, 2] *= 20  # the neighbor count column
    want = np.asarray(jax_forward(jparams, jnp.asarray(x)))
    params = cluster_params_from_numpy(jparams, "cpu")
    got = _np(cluster_forward(params, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_init_is_a_truncated_normal_from_the_generator():
    a = init_cluster_params(torch.Generator().manual_seed(1), device="cpu")
    b = init_cluster_params(torch.Generator().manual_seed(1), device="cpu")
    c = init_cluster_params(torch.Generator().manual_seed(2), device="cpu")
    cfg = ClusterMLPConfig()
    assert a["W_1"].shape == (cfg.num_input, cfg.hidden1)
    assert a["W_2"].shape == (cfg.hidden1, cfg.hidden2)
    assert a["W_O"].shape == (cfg.hidden2, 1)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["W_1"], c["W_1"])
    w = torch.cat([a["W_1"].ravel(), a["W_2"].ravel()])
    assert float(w.abs().max()) <= 0.2
    assert 0.07 < float(w.std()) < 0.1  # 0.1 * 0.88 for a 2-sigma cut
    assert not any(float(a[b_].abs().max()) for b_ in ("b_1", "b_2", "b_O"))


def test_dropout_keeps_about_keep_prob_and_rescales():
    gen = torch.Generator().manual_seed(0)
    h = torch.full((400, 250), 2.0)
    out = _dropout(h, 0.7, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(out[kept], torch.tensor(2.0 / 0.7))
    params = init_cluster_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(64, 14, generator=torch.Generator().manual_seed(1))
    plain = cluster_forward(params, x)
    assert torch.equal(cluster_forward(params, x, 1.0,
                                       torch.Generator().manual_seed(2)), plain)
    a = cluster_forward(params, x, 0.7, torch.Generator().manual_seed(2))
    b = cluster_forward(params, x, 0.7, torch.Generator().manual_seed(2))
    c = cluster_forward(params, x, 0.7, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, plain)


def test_five_adam_steps_match_optax():
    """keep_prob 1, one epoch of 5 minibatches: the same init and batch
    order through cluster_forward + optax.adam, rel 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.rand(320, 14).astype(np.float32)
    y = rng.rand(320).astype(np.float32)
    config = ClusterTrainConfig(epochs=1, batch_size=64, keep_prob=1.0,
                                learning_rate=1e-2, seed=7)
    params, history = train_cluster_model(x, y, config, device="cpu")
    gen = torch.Generator().manual_seed(config.seed)
    init = cluster_params_to_numpy(init_cluster_params(gen, device="cpu"))
    order = torch.randperm(len(x), generator=gen).numpy()

    def loss_fn(p, xb, yb):
        pred = jnp.clip(jax_forward(p, xb), 1e-6, 1.0 - 1e-6)
        return -jnp.mean(yb * jnp.log(pred) + (1.0 - yb) * jnp.log(1.0 - pred))

    opt = optax.adam(config.learning_rate)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jparams)
    losses = []
    for lo in range(0, len(x), 64):
        idx = order[lo : lo + 64]
        loss, grads = jax.value_and_grad(loss_fn)(jparams, x[idx], y[idx])
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        losses.append(float(loss))
    assert len(losses) == 5
    assert history[0] == pytest.approx(np.mean(losses), rel=1e-5)
    got = cluster_params_to_numpy(params)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert not np.array_equal(got[k], init[k])


def test_training_learns_the_neighborhood_rule(tmp_path):
    """tests/test_cluster_train.py's rule and schedule: true fraction ~
    0.7 * own + 0.3 * neighborhood mean."""
    rng = np.random.RandomState(0)
    n = 4000
    own = rng.rand(n)
    partner = rng.rand(n)
    count = rng.randint(0, 10, n).astype(np.float64)
    hist = rng.dirichlet(np.ones(11), n)
    nb_mean = (hist * (np.arange(11) / 10.0)).sum(axis=1)
    x = np.concatenate([own[:, None], partner[:, None], count[:, None], hist],
                       axis=1).astype(np.float32)
    y = np.clip(0.7 * own + 0.3 * nb_mean + rng.normal(0, 0.02, n), 0, 1)
    params, history = train_cluster_model(
        x, y.astype(np.float32),
        ClusterTrainConfig(epochs=100, batch_size=512, learning_rate=3e-3),
        device="cpu")
    assert history[-1] < history[0] - 0.05
    pred = _np(cluster_forward(params, torch.from_numpy(x)))
    assert np.corrcoef(pred, y)[0, 1] > 0.9
    # the loss the trainer minimizes, at the end, without dropout
    final = float(cluster_loss(params, torch.from_numpy(x),
                               torch.from_numpy(y.astype(np.float32)), 1.0,
                               None))
    assert final < history[0]


def test_npz_round_trip_jax_port_jax(tmp_path):
    jparams = jax_init(jax.random.PRNGKey(4), JaxClusterConfig())
    first = str(tmp_path / "jax.npz")
    jax_save(first, jparams)
    params = cluster_params_from_numpy(load_cluster_model(first), "cpu")
    second = str(tmp_path / "port.npz")
    save_cluster_npz(second, params)
    back = jax_load_cluster_model(second)
    assert sorted(back) == sorted(jparams)
    for k, v in jparams.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], np.asarray(v))


def test_non_npz_model_raises():
    """A path that is not an .npz is read as a TF checkpoint: where there
    is none (the reference's default file is absent here), the reader's
    FileNotFoundError names it."""
    with pytest.raises(FileNotFoundError, match=r"Cg\.cov5\.nb25\.index"):
        load_cluster_model("some/checkpoint/Cg.cov5.nb25")
    with pytest.raises(FileNotFoundError, match=r"Cg\.cov5\.nb25\.index"):
        load_cluster_model(None)  # the JAX default: the reference's TF1 file


def _merged_inputs(root, seed, chroms=("chr1", "chr2")):
    """A motif index and a merged BED a chromosome over random CpG
    positions: dense enough that most sites have neighbors, with sites
    off the motif and zero-coverage rows that the reader skips."""
    rng = np.random.RandomState(seed)
    motif_dir = os.path.join(root, "motif")
    os.makedirs(motif_dir, exist_ok=True)
    prefix = os.path.join(root, "pred")
    for chrom in chroms:
        cg = np.unique(rng.randint(0, 6000, 500)) * 2
        with open(os.path.join(motif_dir, f"motif_{chrom}_C.bed"), "w") as fh:
            for p in cg:
                fh.write(f"{chrom}\t{p}\t+\n{chrom}\t{p + 1}\t-\n")
        rows = []
        for p in cg:
            for strand, pos in (("+", p), ("-", p + 1)):
                if rng.rand() < 0.8:
                    rows.append((pos, strand))
        rows += [(int(p) * 2 + 1, "+") for p in rng.randint(0, 6000, 20)]
        with open(f"{prefix}.{chrom}.C.bed", "w") as fh:
            for pos, strand in sorted(rows):
                cov = int(rng.randint(0, 30))
                mod = int(rng.binomial(cov, rng.rand())) if cov else 0
                pct = int(mod * 100 / cov) if cov else 0
                fh.write("%s %d %d C %d %s  %d %d 0,0,0 %d %d %d\n" % (
                    chrom, pos, pos + 1, min(cov, 1000), strand, pos, pos + 1,
                    cov, pct, mod))
    return prefix, motif_dir


def test_features_are_the_jax_bits(tmp_path):
    from deepmod_tpu_torch.tools.cluster_predict import (
        _read_motif_positions,
        _read_pred_bed,
    )

    prefix, motif_dir = _merged_inputs(str(tmp_path), 1, ("chr1",))
    cg = _read_motif_positions(os.path.join(motif_dir, "motif_chr1_C.bed"))
    keys, frac, lines = _read_pred_bed(f"{prefix}.chr1.C.bed", cg)
    assert len(keys) > 500
    got = build_cluster_features(keys, frac)
    want = jax_features(keys, frac)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got[:, 2] > 0).mean() > 0.5


def _assert_rewritten_equal(got_path, want_path, prefs):
    got = open(got_path).read().splitlines()
    want = open(want_path).read().splitlines()
    assert len(got) == len(want) == len(prefs) > 0
    for g, w, p in zip(got, want, prefs):
        g_line, g_pct = g.rsplit(" ", 1)
        w_line, w_pct = w.rsplit(" ", 1)
        assert g_line == w_line
        if g_pct != w_pct:
            assert abs(p * 100 - round(p * 100)) < 1e-4, (g, w, p)


@pytest.mark.parametrize("model", ["golden", "random"])
def test_clusterpred_matches_jax(tmp_path, model):
    root = str(tmp_path)
    prefix, motif_dir = _merged_inputs(root, 2)
    if model == "golden":
        path = os.path.join(GOLDEN, "cluster_weights.npz")
    else:
        path = os.path.join(root, "random.npz")
        jax_save(path, jax_init(jax.random.PRNGKey(9), JaxClusterConfig()))
    chrs = ["chr1", "chr2", "chr3"]  # chr3 has no files: skipped
    n = jax_cluster_predict_run(prefix, motif_dir, path, chrs)
    jax_out = {c: open(f"{prefix}_clusterCpG.{c}.C.bed").read()
               for c in chrs[:2]}
    for c in chrs[:2]:
        os.replace(f"{prefix}_clusterCpG.{c}.C.bed",
                   os.path.join(root, f"jax.{c}.bed"))
    assert n > 1000
    assert cluster_predict_run(prefix, motif_dir, path, chrs,
                               device="cpu") == n
    params = jax_load_cluster_model(path)
    from deepmod_tpu_torch.tools.cluster_predict import (
        _read_motif_positions,
        _read_pred_bed,
    )

    for c in chrs[:2]:
        cg = _read_motif_positions(os.path.join(motif_dir, f"motif_{c}_C.bed"))
        keys, frac, _ = _read_pred_bed(f"{prefix}.{c}.C.bed", cg)
        p = np.asarray(jax_forward(params, jnp.asarray(
            jax_features(keys, frac))))
        _assert_rewritten_equal(f"{prefix}_clusterCpG.{c}.C.bed",
                                os.path.join(root, f"jax.{c}.bed"), p)
        assert jax_out[c].count("\n") == len(keys)
    # the CLI, on the CPU when asked
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = torch_cli.main(["clusterpred", prefix, motif_dir, "--model",
                             path, "--chrs", *chrs, "--device", "cpu"])
    assert rc == 0 and buf.getvalue() == f"rewrote {n} sites\n"


def test_clustertrain_cli(tmp_path):
    root = str(tmp_path)
    prefix, motif_dir = _merged_inputs(root, 3, ("chrT",))
    truth = os.path.join(root, "truth.txt")
    rng = np.random.RandomState(0)
    with open(truth, "w") as fh:
        for p in range(0, 12000, 2):
            fh.write(f"chrT + {p} {rng.rand():.4f}\nchrT - {p + 1} "
                     f"{rng.rand():.4f}\n")
    out = os.path.join(root, "cluster.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = torch_cli.main(["clustertrain", prefix, motif_dir, "--truth",
                             truth, "--out", out, "--chrs", "chrT",
                             "--epochs", "3", "--device", "cpu"])
    assert rc == 0, buf.getvalue()
    assert buf.getvalue().startswith("trained on ")
    params = jax_load_cluster_model(out)  # the JAX package reads the file
    assert sorted(params) == ["W_1", "W_2", "W_O", "b_1", "b_2", "b_O"]
    assert all(np.isfinite(v).all() for v in params.values())


def test_pod5_landscape_cohort_matches_fast5(tmp_path):
    """write_move_dataset_pod5 with a given genome and a mod_site_prob
    landscape simulates the reads generate_dataset writes as move-style
    fast5 from the same seed: detect gives the same BEDs over both."""
    from deepmod_tpu_torch.engine.detect import DetectConfig, detect_run
    from deepmod_tpu_torch.models.bilstm import (
        BiLSTMConfig,
        init_bilstm_params,
    )
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
    from deepmod_tpu_torch.testing.synthetic import (
        SynthConfig,
        generate_dataset,
        make_clustered_site_prob,
        make_genome,
        write_move_dataset_pod5,
    )

    root = str(tmp_path)
    rng = np.random.RandomState(42)
    genome = make_genome(rng, {"chrT": 6000, "chrE": 6000})
    landscape = make_clustered_site_prob(rng, genome, tile=250)
    config = SynthConfig(genome_sizes={}, num_reads=6, read_length=(600, 900),
                         seed=13, fast5_style="move",
                         mod_site_prob=landscape, mod_level_shift=2.5)
    g5, fast5_reads = generate_dataset(os.path.join(root, "f5"), config,
                                       genome=genome)
    gp, pod5_reads, _ = write_move_dataset_pod5(os.path.join(root, "p5"),
                                                config, genome=genome)
    assert g5 == gp == genome
    assert [(r.chrom, r.strand, r.start, r.seq) for r in fast5_reads] == [
        (r.chrom, r.strand, r.start, r.seq) for r in pod5_reads]
    cfg = BiLSTMConfig(num_hidden=16, num_layers=1)
    model = os.path.join(root, "m.npz")
    save_bilstm_npz(model, init_bilstm_params(0, cfg, device="cpu"), cfg)
    beds = {}
    for tag, extra in (
            ("f5", dict(wrk_base=os.path.join(root, "f5", "fast5"))),
            ("p5", dict(wrk_base=os.path.join(root, "p5", "pod5"),
                        basecalls=os.path.join(root, "p5", "calls.bam")))):
        out = os.path.join(root, f"out_{tag}")
        res = detect_run(DetectConfig(
            ref=os.path.join(root, tag, "ref.fa"), model_path=model,
            out_folder=out, align_str="builtin", hidden=16, device="cpu",
            precision="fp32", write_per_read=False, move=True, **extra))
        assert res.num_reads == 6, res.errors
        beds[tag] = {os.path.basename(p): open(p, "rb").read()
                     for p in res.bed_files}
    assert len(beds["f5"]) >= 2 and beds["f5"] == beds["p5"]


def test_validate_cluster_loop_runs_on_the_cpu(tmp_path, monkeypatch):
    """tools/validate_cluster_loop.py's run from the cohorts to the report,
    on the CPU at a tiny size, with the first stage replaced by a fixed
    model whose calls depend on the window (training one takes minutes
    here; chip_smoke.py trains it on the card)."""
    from deepmod_tpu_torch.models.bilstm import (
        BiLSTMConfig,
        init_bilstm_params,
    )
    from deepmod_tpu_torch.models.tf_import import save_bilstm_npz
    from deepmod_tpu_torch.tools import validate_cluster_loop as loop

    def first_stage(cfg):
        config = BiLSTMConfig()
        params = init_bilstm_params(3, config, device="cpu")
        for lane in ("fw", "bw"):
            for lp in params[lane]:
                lp["kernel"] *= 6
        rng = np.random.RandomState(5)
        params["out_w"] = torch.from_numpy(
            rng.normal(0, 1.0, (200, 2)).astype(np.float32))
        params["out_b"] = torch.tensor([0.0, -6.0])
        path = os.path.join(cfg.out, "m.npz")
        save_bilstm_npz(path, params, config)
        return path

    monkeypatch.setattr(loop, "train_first_stage", first_stage)
    monkeypatch.setattr(loop, "CLUSTER_EPOCHS", 5)
    cfg = loop.LoopConfig(out=str(tmp_path / "loop"), device="cpu",
                          chrom_size=3000, n_train=0, n_cohort=24,
                          shift=2.5, threads=1)
    report = loop.run_loop(cfg)
    for tag in ("chrE_cov5_trained", "chrE_cov1_trained", "chrE_cov5_bundled",
                "chrT_cov5_train_chrom"):
        m = report[tag]
        assert m is not None and m["n_sites"] > 100, (tag, m)
        for key in ("auc_before", "auc_after", "ap_before", "ap_after"):
            assert 0.0 < m[key] < 1.0, (tag, key, m)
    # the bundled model rewrote the same sites as the trained one
    runs = os.path.join(cfg.out, "runs")
    for chrom in loop.CHROMS:
        a = loop.read_rewritten(
            os.path.join(runs, f"pred_clusterCpG.{chrom}.C.bed"))
        b = loop.read_rewritten(
            os.path.join(runs, f"pred_bundled_clusterCpG.{chrom}.C.bed"))
        assert a and a.keys() == b.keys()
