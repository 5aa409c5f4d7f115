"""PyTorch/CUDA port of ``asyncframework_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package keeps its module names
so each counterpart is easy to find, imports ``torch`` and numpy (never
``jax`` or ``asyncframework_tpu``), and runs its hot contraction through a
hand-written CUDA kernel (``csrc/``, built at first use).  Entry points
default to ``cuda`` and raise when no GPU is present, unless the caller
passes ``devices=[torch.device("cpu")]``.
"""

__version__ = "0.1.0"
