"""The plain reference agrees with a BiLSTM built by hand, and its
controls are the precisions they say."""

import json
import os

import numpy as np
import pytest
import torch

from bench_h100 import reference
from bench_h100.weights import make_weights
from conftest import BENCH


def tiny_config(**over):
    with open(os.path.join(BENCH, "configs", "deepmod_f7_fp32.json")) as fh:
        cfg = json.load(fh)
    cfg.update(num_hidden=5, num_layers=2, timesteps=7)
    cfg.update(over)
    return cfg


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def hand_logits(w, x, cfg):
    """One window at a time, one cell at a time, TF1's BasicLSTMCell and
    static_bidirectional_rnn written out in numpy float64."""
    w = {k: v.double().numpy() for k, v in w.items()}
    hid, fb = cfg["num_hidden"], cfg["forget_bias"]
    out = []
    for win in x.double().numpy():
        feats = []
        for lane, seq in (("fw", win), ("bw", win[::-1])):
            inputs = list(seq)
            for layer in range(cfg["num_layers"]):
                kern = w[f"{lane}.{layer}.kernel"]
                bias = w[f"{lane}.{layer}.bias"]
                h, c, outs = np.zeros(hid), np.zeros(hid), []
                for xt in inputs:
                    z = np.concatenate([xt, h]) @ kern + bias
                    i, j, f, o = (z[k * hid : (k + 1) * hid] for k in range(4))
                    c = c * sigmoid(f + fb) + sigmoid(i) * np.tanh(j)
                    h = np.tanh(c) * sigmoid(o)
                    outs.append(h)
                inputs = outs
            # the bw outputs reversed back: the center step of both lanes
            center = cfg["timesteps"] // 2
            feats.append(inputs[center] if lane == "fw"
                         else inputs[cfg["timesteps"] - 1 - center])
        z = np.concatenate(feats) @ w["out_w"] + w["out_b"]
        out.append(sigmoid(z) if cfg["output_layer"] == "sigmoid" else z)
    return np.array(out)


@pytest.mark.parametrize("output_layer", ["", "sigmoid"])
def test_reference_matches_a_hand_built_bilstm(output_layer):
    cfg = tiny_config(output_layer=output_layer)
    w = make_weights(cfg, 4, "cpu")
    x = torch.randn(6, cfg["timesteps"], cfg["num_input"],
                    generator=torch.Generator().manual_seed(0))
    got = reference.logits(w, x, cfg, "fp64").numpy()
    np.testing.assert_allclose(got, hand_logits(w, x, cfg), rtol=0, atol=1e-12)


def test_window_logits_cut_the_windows_around_their_centers():
    cfg = tiny_config()
    w = make_weights(cfg, 5, "cpu")
    rows = torch.randn(40, 7, generator=torch.Generator().manual_seed(1))
    centers = torch.tensor([3, 4, 20, 36])
    got = reference.window_logits(w, rows, centers, cfg, block=3)
    x = torch.stack([rows[c - 3 : c + 4] for c in centers.tolist()])
    torch.testing.assert_close(got, reference.logits(w, x, cfg), rtol=0, atol=0)


def test_reference_gradients_are_the_loss_derivative():
    cfg = tiny_config()
    w = {k: v.double() for k, v in make_weights(cfg, 6, "cpu").items()}
    x = torch.randn(4, 7, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    y = torch.nn.functional.one_hot(torch.arange(4) % 2, 2).double()
    mask = torch.ones(4, dtype=torch.float64)
    names = list(w)

    def f(*leaves):
        return reference.loss(dict(zip(names, leaves)), x, y, mask, cfg, "fp64")

    leaves = [w[k].clone().requires_grad_(True) for k in names]
    assert torch.autograd.gradcheck(f, leaves, eps=1e-6, atol=1e-7)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.0])
    got = reference._round_tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]


def test_controls_are_coarser_than_the_reference():
    cfg = tiny_config(num_hidden=32, num_layers=3, timesteps=21)
    w = make_weights(cfg, 7, "cpu")
    x = torch.randn(256, 21, 7, generator=torch.Generator().manual_seed(3))
    ref = reference.logits(w, x, cfg, "fp64")
    err = {m: float((reference.logits(w, x, cfg, m).double() - ref).abs().max())
           for m in ("tf32", "fp8")}
    assert 1e-6 < err["tf32"] < 1e-2
    assert err["fp8"] > 10 * err["tf32"]


def test_train_steps_follow_adam():
    cfg = tiny_config()
    w = make_weights(cfg, 8, "cpu")
    x = torch.randn(2, 8, 7, 7, generator=torch.Generator().manual_seed(4))
    y = torch.nn.functional.one_hot(torch.arange(8) % 2, 2).float()
    mask = torch.ones(8)
    out = reference.train(w, [(x[0], y, mask), (x[1], y, mask)], cfg, 1e-3)
    assert len(out["losses"]) == 2
    # Adam's first step moves every leaf by lr times the gradient's sign,
    # to within eps
    one = reference.train(w, [(x[0], y, mask)], cfg, 1e-3)
    for k, g in one["first_grads"].items():
        step = (w[k].double() - one["params"][k]) / 1e-3
        keep = g.abs() > 1e-6
        torch.testing.assert_close(step[keep], torch.sign(g[keep]),
                                   rtol=0, atol=1e-2)
