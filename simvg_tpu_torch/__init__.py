"""simvg_tpu_torch: the PyTorch/CUDA port of ``simvg_tpu`` for NVIDIA Hopper.

The JAX package ``simvg_tpu`` stays the reference; every part of this
package is held against its counterpart there.  Plain tensor code is
PyTorch; the attention core of the BEiT-3 encoder is two hand-written CUDA
kernels, forward (``csrc/attention_fwd.cu``) and backward
(``csrc/attention_bwd.cu``), built with ``nvcc`` at first use.
This package imports no JAX and nothing of ``simvg_tpu``.
"""

__version__ = "0.1.0"
