"""femasr_torch: the PyTorch/CUDA port of FeMaSR serving.

Counterpart of femasr_tpu (the JAX reference) with the same module layout
(ops/, models/). Its Pallas TPU kernels are hand-written CUDA kernels for
Hopper under kernels/ (sources in csrc/), built with nvcc at first use.
Entry points run on the card unless the caller passes device='cpu'.
"""

__version__ = '0.1.0'
