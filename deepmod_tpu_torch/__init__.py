"""deepmod_tpu_torch — the PyTorch/CUDA port of deepmod_tpu.

The JAX package ``deepmod_tpu`` stays the reference; this package imports
nothing of it. Host layers (io, align, features, aggregate, engine host
stages, testing) are its own copies of the JAX package's numpy code and
of its C++ host library (``native``); the
BiLSTM classifier runs on ``torch`` with kernels hand-written in CUDA for
Hopper (``csrc/bilstm_fused.cu`` and ``csrc/bilstm_layer.cu`` for
inference, ``csrc/bilstm_mono_*.cu`` for the mono kernel's other
schedules, ``csrc/bilstm_train.cu`` for training, ``csrc/lstm_layer.cu``
for one-direction layers, ``csrc/probe_transcendental.cu`` for the rate
probe), built with nvcc at first use.

Entry points take an explicit device, ``"cuda"`` by default; the CPU is
used only when asked for (``device="cpu"``, ``--device cpu``).

    deepmod_tpu_torch.models  - BiLSTM classifier, cluster MLP, .npz and TF1
                                checkpoints (read without TensorFlow)
    deepmod_tpu_torch.ops     - the CUDA kernel wrappers and their plain versions
    deepmod_tpu_torch.engine  - the detect and getfeatures pipelines
    deepmod_tpu_torch.train   - feature-file loading and the trainer
    deepmod_tpu_torch.serve   - the long-lived HTTP detection service
    deepmod_tpu_torch.tools   - the transcendental-rate, mono-schedule and
                                serving-latency probes, the host-stage and
                                detect benchmarks, the post-hoc tools
    deepmod_tpu_torch.native  - the native host library (C++, built at first use)
    deepmod_tpu_torch.io, align, features, aggregate, utils, testing
"""

__version__ = "0.1.0"
