"""BiLSTM training on one card, or on the CPU when asked for; data
parallel over a mesh or over ``torch.distributed`` ranks.

The reference trains single-process single-device with a Python feed loop
(train_save_model, myMultiBiRNN.py:96-228); ``deepmod_tpu/train/
trainer.py`` runs the same optimization as a jitted step. Here: Adam lr
1e-3, batch 2048, 4 epochs, optional class-weighted loss, the masked mean
over bucket-padded minibatches, per-epoch and mid-epoch ``.npz``
checkpoints that carry the Adam slots. Forward and backward run through
the training kernels (K2/K3 on the card, their plain versions on the
CPU).

Under an initialized ``torch.distributed`` group (a rank a card, as
torchrun starts them), or over a ``parallel.mesh.Mesh`` the caller
passes, the step is data parallel (``parallel.shardings``): the padded
batch splits over every shard of every process, each shard runs K2/K3 on
its rows, and the loss and gradient sums are reduced before the masked
mean, so every process applies the same Adam update. A process alone
trains on its one card, also on a machine with several: a mesh of
several cards in one process steps slower than one card (PERF.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepmod_tpu_torch.models.bilstm import (
    BiLSTMConfig,
    bilstm_example_losses,
    bilstm_logits,
    bilstm_predict,
    init_bilstm_params,
)
from deepmod_tpu_torch.models.tf_import import (
    load_adam_state,
    params_from_numpy,
    save_bilstm_npz,
)
from deepmod_tpu_torch.tools.evaluate import roc_auc_score as roc_auc
from deepmod_tpu_torch.utils.device import resolve_device
from deepmod_tpu_torch.utils.profiling import span
from .loader import TestSplit, iterate_training_batches, load_feature_file


@dataclasses.dataclass
class TrainConfig:
    out_folder: str
    file_id: str = "mod"
    fnum: int = 7
    hidden: int = 100
    window_size: int = 21
    epochs: int = 4                # training_steps (myMultiBiRNN.py:97)
    batch_size: int = 2048         # :12
    learning_rate: float = 1e-3    # :27
    unbalanced: bool = False       # :64-65 class-weighted loss
    output_layer: str = ""
    test: Optional[str] = None     # 'E,1,2' | 'P,10'
    seed: int = 0
    log_every: int = 10
    # 'bf16' stores the training kernels' residual and gradient sequences
    # in bfloat16 (fp32 weights, compute, carries and weight gradients);
    # fp32 is the mode pinned against the JAX package's scan path
    precision: str = "fp32"
    device: str = "cuda"


def _pad_to(batch_x: np.ndarray, batch_y: np.ndarray, multiple: int,
            bucket: int = 256):
    """Pad a minibatch up to a BUCKET boundary, with a mask.

    np.array_split hands the train loop slightly-varying sizes (2083,
    2084, arbitrary tails); rounding up to ``bucket`` keeps the set of
    step shapes to a handful for the whole run. Padded rows are zeros with
    mask 0, so they carry no gradient."""
    n = len(batch_y)
    q = max(bucket, multiple)
    target = ((max(n, 1) + q - 1) // q) * q
    target = ((target + multiple - 1) // multiple) * multiple
    if target == n:
        mask = np.ones(n, np.float32)
        return batch_x, batch_y, mask
    pad = target - n
    x = np.concatenate([batch_x, np.zeros((pad,) + batch_x.shape[1:], batch_x.dtype)])
    y = np.concatenate([batch_y, np.zeros((pad, 2), batch_y.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return x, y, mask


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The trainable tensors in a fixed order (the Adam slots follow it)."""
    return [lp[key] for lane in ("fw", "bw") for lp in params[lane]
            for key in ("kernel", "bias")] + [params["out_w"], params["out_b"]]


def adam_init(params: Dict[str, Any]) -> Dict[str, Any]:
    """Zero Adam slots shaped like ``params`` and a step count of 0."""
    def zeros(tree):
        out = {lane: [{k: torch.zeros_like(v) for k, v in lp.items()}
                      for lp in tree[lane]] for lane in ("fw", "bw")}
        out["out_w"] = torch.zeros_like(tree["out_w"])
        out["out_b"] = torch.zeros_like(tree["out_b"])
        return out

    return {"count": 0, "mu": zeros(params), "nu": zeros(params)}


@torch.no_grad()
def adam_update(params: Dict[str, Any], grads: Sequence[torch.Tensor],
                state: Dict[str, Any], learning_rate: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                leaves: Callable = param_leaves) -> None:
    """One Adam step in place, in optax.adam's order of operations:
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; the bias corrections
    1 - b^count in fp32; p += -lr * (mu_hat / (sqrt(nu_hat) + eps)).
    ``leaves`` lists a params tree's tensors in the order of ``grads``
    (the cluster MLP passes its own)."""
    count = state["count"] + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    for p, g, m, v in zip(leaves(params), grads,
                          leaves(state["mu"]), leaves(state["nu"])):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.add_(-learning_rate * update)
    state["count"] = count


def make_train_step(
    model_config: BiLSTMConfig,
    unbalanced: bool,
    precision: str = "fp32",
    learning_rate: float = 1e-3,
    mesh=None,
) -> Callable:
    """(params, opt_state, x, y, mask) -> loss; updates params and the
    Adam state in place. The loss is the masked mean of
    ``bilstm_example_losses`` (class-weighted logits with ``unbalanced``).
    With a ``parallel.mesh.Mesh``, the data-parallel step over its shards
    and processes (``parallel.shardings.make_sharded_train_step``; x, y
    and mask are then this process's rows)."""
    if mesh is not None:
        from deepmod_tpu_torch.parallel.mesh import Mesh
        from deepmod_tpu_torch.parallel.shardings import (
            make_sharded_train_step,
        )

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        return make_sharded_train_step(model_config, learning_rate, mesh,
                                       unbalanced, precision)

    def step(params, opt_state, x, y, mask):
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with span("train.forward"):
                per_example = bilstm_example_losses(params, x, y, model_config,
                                                    unbalanced, precision)
                loss = torch.sum(per_example * mask) / torch.clamp(mask.sum(),
                                                                   min=1.0)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with span("train.adam"):
            adam_update(params, grads, opt_state, learning_rate)
        return loss.detach()

    return step


def batch_metrics(params, model_config, x, y) -> Dict[str, float]:
    """loss/acc/AUC/precision/recall on one batch (the reference's
    periodic sess.run of its metric ops, myMultiBiRNN.py:176-184), through
    the inference path (K1 or K4 in fp32 on the card, by window size).
    AUC is 0.0 when the batch holds one class only, as in the JAX
    package."""
    device = params["out_w"].device
    with torch.no_grad():
        logits = bilstm_logits(params, torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(device), model_config,
            "fp32").cpu().numpy()
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    pred = probs.argmax(axis=1)
    truth = y.argmax(axis=1)
    logp = np.log(np.maximum(probs, 1e-12))
    loss = float(-np.mean((y * logp).sum(axis=1)))
    acc = float((pred == truth).mean())
    tp = int(((pred == 1) & (truth == 1)).sum())
    fp = int(((pred == 1) & (truth == 0)).sum())
    fn = int(((pred == 0) & (truth == 1)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    auc = roc_auc(truth, probs[:, 1]) if len(set(truth)) > 1 else 0.0
    return {"loss": loss, "acc": acc, "auc": auc, "p": precision, "r": recall}


def train_run(
    file_groups: Sequence[Sequence[str]],
    config: TrainConfig,
    init_params=None,
    resume_opt_from: Optional[str] = None,
    mesh=None,
) -> Tuple[Any, BiLSTMConfig, List[Dict[str, float]]]:
    """Full training loop; returns (params, model_config, metric history).

    ``file_groups``: list of feature-file lists; group 0 drives the epoch
    (largest group first, like myMultiBiRNN.py:457-458). ``init_params``
    (numpy or torch tree) resumes from existing weights;
    ``resume_opt_from`` (an .npz written by either package's trainer)
    also restores the Adam slots and step count, so a resume continues
    the interrupted run exactly. ``mesh`` (a ``parallel.mesh.Mesh``)
    trains data parallel over its shards; under an initialized
    ``torch.distributed`` group the default is this process's device, one
    shard a rank. Otherwise the run takes ``config.device`` alone (the
    JAX trainer builds a mesh over every device; here one card a process
    is the faster step). Under a group, process 0 alone writes the
    checkpoints."""
    from deepmod_tpu_torch.parallel.mesh import default_group, make_mesh

    device = resolve_device(config.device)
    model_config = BiLSTMConfig(
        num_input=config.fnum,
        num_hidden=config.hidden,
        timesteps=config.window_size,
        output_layer=config.output_layer,
    )
    if init_params is None:
        params = init_bilstm_params(config.seed, model_config, device=device)
    else:
        params = params_from_numpy(init_params, device)
    opt_state = None
    if resume_opt_from is not None:
        opt_state = load_adam_state(resume_opt_from, params)
    if opt_state is None:
        opt_state = adam_init(params)
    if mesh is None and default_group() is not None:
        mesh = make_mesh(devices=[device])  # this process's own device
    n_shards = mesh.size if mesh is not None else 1
    # one writer of the checkpoints: every process holds the same params
    lead = mesh is None or mesh.process_index() == 0
    step_fn = make_train_step(model_config, config.unbalanced,
                              config.precision, config.learning_rate, mesh)

    split = TestSplit.parse(config.test)
    history: List[Dict[str, float]] = []
    os.makedirs(config.out_folder, exist_ok=True)
    start = time.time()
    io_time = 0.0

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    for epoch in range(1, config.epochs + 1):
        step_count = 0
        epoch_files = len(file_groups[0])
        saved_half = False
        progress: Dict[str, int] = {"files_consumed": 0}
        io_mark = time.time()
        for group_batches in iterate_training_batches(
            file_groups,
            batch_size=config.batch_size,
            window_size=config.window_size,
            split=split,
            progress=progress,
        ):
            io_time += time.time() - io_mark
            for bx, by in group_batches:
                if len(by) == 0:
                    continue
                x, y, mask = _pad_to(bx, by, n_shards)
                if mesh is not None:
                    # every process loads the same batch and trains on its
                    # contiguous share (the JAX global batch's P('data'))
                    rows = len(mask) // mesh.process_count()
                    mine = slice(mesh.process_index() * rows,
                                 (mesh.process_index() + 1) * rows)
                    x, y, mask = x[mine], y[mine], mask[mine]
                step_fn(params, opt_state, to_dev(x), to_dev(y), to_dev(mask))
            step_count += 1
            if step_count % config.log_every == 0:
                # evaluate across ALL groups' current minibatches: a
                # single group is often single-class (mod vs control
                # folders), which pins AUC/precision/recall to 0
                mx = np.concatenate([b[0] for b in group_batches if len(b[1])])
                my_ = np.concatenate([b[1] for b in group_batches if len(b[1])])
                m = batch_metrics(params, model_config, mx, my_)
                m["epoch"] = epoch
                m["step"] = step_count
                m["io_frac"] = io_time / max(time.time() - start, 1e-9)
                history.append(m)
                print(
                    f"[train] epoch {epoch} step {step_count} "
                    f"loss={m['loss']:.3f} auc={m['auc']:.3f} acc={m['acc']:.3f} "
                    f"p={m['p']:.3f} r={m['r']:.3f} io={m['io_frac']:.2f}",
                    flush=True,
                )
            # mid-epoch checkpoint at ~50% of group-0 FILES consumed —
            # the reference's unit (myMultiBiRNN.py:210-214)
            if (lead and not saved_half and epoch_files
                    and progress["files_consumed"] >= epoch_files // 2 > 0):
                half_dir = os.path.join(config.out_folder, f"{epoch - 1}.50")
                os.makedirs(half_dir, exist_ok=True)
                save_bilstm_npz(
                    os.path.join(half_dir, config.file_id + ".npz"),
                    params, model_config, opt_state=opt_state,
                )
                saved_half = True
            io_mark = time.time()
        if lead:
            epoch_dir = os.path.join(config.out_folder, str(epoch))
            os.makedirs(epoch_dir, exist_ok=True)
            save_bilstm_npz(
                os.path.join(epoch_dir, config.file_id + ".npz"),
                params, model_config, opt_state=opt_state,
            )
    return params, model_config, history


def predict_feature_files(
    params,
    model_config: BiLSTMConfig,
    feature_files: Sequence[str],
    out_path: str,
    window_size: int = 21,
    batch_size: int = 2048,
    split: Optional[TestSplit] = None,
    device: str = "cuda",
) -> Dict[str, Tuple[int, int, int, int]]:
    """Standalone prediction over feature files with tp/fp/fn/tn per file
    (mPred, myMultiBiRNN.py:382-420), through the inference path (K1 or
    K4 in fp32 on the card, by window size)."""
    params = params_from_numpy(params, device)
    dev = params["out_w"].device
    results: Dict[str, Tuple[int, int, int, int]] = {}
    with open(out_path, "w") as fh, torch.no_grad():
        for path in feature_files:
            x, y = load_feature_file(path, window_size, split, for_test=True)
            if len(y) == 0:
                continue
            pred = np.concatenate([
                bilstm_predict(params, torch.from_numpy(
                    x[lo : lo + batch_size]).to(dev), model_config).cpu().numpy()
                for lo in range(0, len(x), batch_size)
            ])
            truth = y.argmax(axis=1)
            tp = int(((pred == 1) & (truth == 1)).sum())
            fp = int(((pred == 1) & (truth == 0)).sum())
            fnn = int(((pred == 0) & (truth == 1)).sum())
            tn = int(((pred == 0) & (truth == 0)).sum())
            results[path] = (tp, fp, fnn, tn)
            fh.write(f"tp={tp} fp={fp} fn={fnn} tn={tn} {path}\n")
    return results
