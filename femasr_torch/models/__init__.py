"""FeMaSRNet, parameter conversion and the serving wrapper."""

from .femasr_arch import FeMaSRNet, init_weights
from .inference import SRInferencer, load_inferencer

__all__ = ['FeMaSRNet', 'init_weights', 'SRInferencer', 'load_inferencer']
