"""A run of each cell kind on the CPU, at widths as published and a small
traffic: sound, it comes out correct; with the timed path broken
underneath, or with the control (the reference one precision lower) in
the program's place, it does not. The cells have one chip each, so no
fault of an exchange between chips applies."""

import numpy as np
import pytest
import torch

from bench_h100 import reference
from bench_h100.weights import from_port_params
from conftest import run_cell


def result(root, cell, capsys, trace=0):
    rc, line = run_cell(root, cell, seconds=1.0, trace=trace, capsys=capsys)
    assert rc == 0 and line is not None
    return line


@pytest.mark.parametrize("cell", ["d_bf16", "d_fp32", "t_fp32"])
def test_a_sound_run_is_correct(root, cell, capsys):
    line = result(root, cell, capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for value, limit in line["checks"].values():
        assert value <= limit


@pytest.mark.parametrize("cell", ["d_fp32", "t_fp32"])
def test_a_traced_run_gives_the_per_layer_metrics(root, cell, capsys):
    line = result(root, cell, capsys, trace=1)
    assert line["correct"] is True
    assert "window_s" in line["device"] and "breakdown" in line
    names = set(line["metrics"])
    assert ("detect_transfer_bytes_per_window.fp32" in names if cell[0] == "d"
            else "train_mfu" in names)
    assert not names & {"setup_s", "detect_windows_per_s",
                        "detect_windows_per_s.fp32", "train_samples_per_s"}


def _patch_answers(monkeypatch, change):
    from deepmod_tpu_torch.engine.detect import WindowPredictor

    orig = WindowPredictor.predict_from_features

    def broken(self, features, centers, window=21, assume_packable=False):
        out = orig(self, features, centers, window, assume_packable).copy()
        return change(self, features, centers, window, out)

    monkeypatch.setattr(WindowPredictor, "predict_from_features", broken)


def _half_left_out(self, features, centers, window, out):
    out[len(out) // 2 :] = 0
    return out


def _one_altered(self, features, centers, window, out):
    out[len(out) // 3] = 1 - out[len(out) // 3]
    return out


def _control(mode):
    def answers(self, features, centers, window, out):
        weights = {k: v.cpu() for k, v in from_port_params(self.params).items()}
        cfg = {"num_hidden": self.config.num_hidden,
               "num_layers": self.config.num_layers,
               "num_classes": self.config.num_classes,
               "timesteps": window, "forget_bias": self.config.forget_bias,
               "output_layer": self.config.output_layer}
        ref = reference.window_logits(weights, torch.from_numpy(features),
                                      torch.from_numpy(np.asarray(centers)),
                                      cfg, mode)
        return ref.argmax(dim=1).numpy().astype(np.int8)
    return answers


@pytest.mark.parametrize("cell,fault", [
    ("d_bf16", _half_left_out), ("d_fp32", _half_left_out),
    ("d_fp32", _one_altered),
    ("d_bf16", _control("fp8")), ("d_fp32_wide", _control("tf32")),
], ids=["half-bf16", "half-fp32", "altered-fp32", "control-fp8",
        "control-tf32"])
def test_detect_faults_are_not_correct(root, cell, fault, monkeypatch, capsys):
    _patch_answers(monkeypatch, fault)
    line = result(root, cell, capsys)
    assert line["correct"] is False, line["checks"]


def _train_step_patch(monkeypatch, wrap):
    from deepmod_tpu_torch.train import trainer

    orig = trainer.make_train_step

    def make(*args, **kwargs):
        return wrap(orig(*args, **kwargs), trainer)

    monkeypatch.setattr(trainer, "make_train_step", make)


def _state_unchanged(monkeypatch):
    from deepmod_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "adam_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    def wrap(step, trainer):
        def half(params, opt, x, y, mask):
            keep = mask.clone()
            keep[len(keep) // 2 :] = 0
            return step(params, opt, x, y, keep)
        return half
    _train_step_patch(monkeypatch, wrap)


def _train_control(monkeypatch):
    """The reference's loss and gradients in TF32 in the program's place,
    then the program's Adam."""
    def wrap(step, trainer):
        def control(params, opt, x, y, mask):
            flat = from_port_params(params)
            names = list(flat)
            leaves = [flat[k].detach().clone().requires_grad_(True)
                      for k in names]
            hidden = flat["out_w"].shape[0] // 2
            cfg = {"num_hidden": hidden, "num_layers": len(params["fw"]),
                   "num_classes": flat["out_w"].shape[1],
                   "timesteps": x.shape[1], "forget_bias": 1.0,
                   "output_layer": ""}
            with reference._no_tf32():
                loss = reference.loss(dict(zip(names, leaves)), x, y, mask,
                                      cfg, "tf32")
                grads = torch.autograd.grad(loss, leaves)
            by_name = dict(zip(names, grads))
            trainer.adam_update(params, [by_name[k] for k in
                                         _leaf_order(params)], opt, 1e-3)
            return loss.detach()
        return control
    _train_step_patch(monkeypatch, wrap)


def _leaf_order(params):
    names = []
    for lane in ("fw", "bw"):
        for layer in range(len(params[lane])):
            names += [f"{lane}.{layer}.kernel", f"{lane}.{layer}.bias"]
    return names + ["out_w", "out_b"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _train_control],
                         ids=["state-unchanged", "half-batch", "control-tf32"])
def test_train_faults_are_not_correct(root, fault, monkeypatch, capsys):
    fault(monkeypatch)
    line = result(root, "t_fp32", capsys)
    assert line["correct"] is False, line["checks"]
