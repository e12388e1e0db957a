"""femasr_torch: the PyTorch/CUDA port of FeMaSR serving, training and
evaluation, and of the SwinIR model family (models/swinir_arch.py).

Counterpart of femasr_tpu (the JAX reference) with the same module layout
(ops/, models/, losses/, metrics/, train/, data/, utils/). Its Pallas TPU
kernels are hand-written CUDA kernels for Hopper under kernels/ (sources
in csrc/), built with nvcc at first use; csrc/ also holds the `.fmrs`
shard store's host library (g++). Entry points (inference_cli, train_cli,
test_cli, generate_dataset) run on the card unless the caller asks for
the CPU; scripts/ holds the data-preparation scripts.
"""

__version__ = '0.1.0'
