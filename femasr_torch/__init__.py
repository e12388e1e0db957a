"""femasr_torch: the PyTorch/CUDA port of FeMaSR serving, training and
evaluation, and of the SwinIR model family (models/swinir_arch.py).

Counterpart of femasr_tpu (the JAX reference) with the same module layout
(ops/, models/, losses/, metrics/, train/, data/, utils/). Its Pallas TPU
kernels are hand-written CUDA kernels for Hopper under kernels/ (sources
in csrc/), built with nvcc at first use. Entry points (inference_cli,
train_cli, test_cli) run on the card unless the caller asks for the CPU.
"""

__version__ = '0.1.0'
