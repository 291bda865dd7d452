"""The CUDA kernel K1 against its plain version, on the card.

Marked ``gpu``: each test skips (inside its fixture) where no CUDA GPU is
present. On a machine with a GPU and nvcc (the repo's conftest imports
JAX, which this file does not need):

    python -m pytest tests/test_torch_kernel_gpu.py --noconftest -q

Tolerances: fp32 2e-5 absolute (different summation order, accurate
expf/tanhf on both sides, TF32 off); bf16 atol 2e-3 + rtol 2e-2 (a 1-ulp
bf16 rounding flip of a stored h propagates).
"""

import numpy as np
import pytest
import torch

from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, init_bilstm_params
from deepmod_tpu_torch.ops import bilstm_fused as ops

pytestmark = pytest.mark.gpu

TOL = {"fp32": dict(rtol=0.0, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("timesteps,layers,hidden,batch", [
    (21, 3, 100, 1000),   # production shape, ragged last tile
    (5, 1, 16, 7),        # one partial tile
    (9, 2, 40, 129),
    (25, 3, 64, 64),      # longest T the kernel takes
])
def test_kernel_matches_plain(cuda, precision, timesteps, layers, hidden,
                              batch):
    cfg = BiLSTMConfig(num_input=7, num_hidden=hidden, timesteps=timesteps,
                       num_layers=layers)
    params = init_bilstm_params(timesteps + layers, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
        (batch, timesteps, 7), dtype=np.float32)).to(cuda)
    x = x.to(ops.seq_dtype(precision))
    before = ops.LAUNCHES[precision]
    got = ops.bilstm_center_features(params, x, cfg, precision)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[precision] == before + 1
    want = ops.bilstm_center_plain(params, x, cfg, precision)
    torch.testing.assert_close(got, want, **TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_kernel_reads_overlapping_window_view(cuda, precision):
    """The compact path's (rows-T+1, T, F) view of a (rows, F) block gives
    the same features as the materialized windows."""
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(3, cfg, device=cuda)
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, 7), dtype=np.float32)).to(cuda).to(ops.seq_dtype(precision))
    view = rows.as_strided((300 - 21 + 1, 21, 7), (7, 7, 1))
    got = ops.bilstm_center_features(params, view, cfg, precision)
    want = ops.bilstm_center_features(params, view.contiguous(), cfg,
                                      precision)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile_b", [8, 16, 40])
def test_kernel_tiles_agree(cuda, tile_b):
    cfg = BiLSTMConfig(num_input=7)
    params = init_bilstm_params(4, cfg, device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (333, 21, 7), dtype=np.float32)).to(cuda)
    a = ops.bilstm_center_features(params, x, cfg, "fp32", tile_b=tile_b)
    b = ops.bilstm_center_features(params, x, cfg, "fp32")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_rejects_unported_windows(cuda):
    cfg = BiLSTMConfig(num_input=7, timesteps=20)
    params = init_bilstm_params(5, cfg, device=cuda)
    x = torch.zeros(4, 20, 7, device=cuda)
    with pytest.raises(NotImplementedError, match="K4"):
        ops.bilstm_center_features(params, x, cfg, "fp32")
