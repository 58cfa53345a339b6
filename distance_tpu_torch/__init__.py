"""distance_tpu_torch — the pairwise genetic-distance engine in PyTorch and
CUDA, for one NVIDIA Hopper GPU.

The port of ``distance_tpu`` (JAX on a TPU), which stays beside it as the
reference.  It computes the same integer counters with a hand-written
CUDA kernel (``csrc/counters.cu``) and writes byte-identical TSVs.  It
imports ``torch`` and never ``jax``: the host modules it shares with
``distance_tpu`` are copies, pinned to their originals by
``tests/test_torch_host_copies.py``.  Entry point: ``distance-tpu-torch``
(``distance_tpu_torch.cli:main``).
"""

__version__ = "0.1.0"
