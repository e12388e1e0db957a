"""The port's networks, parameter conversion, the serving wrapper and the
options-driven factory `build_network` (femasr_tpu/models/__init__.py)."""

from copy import deepcopy

from ..utils.registry import ARCH_REGISTRY
from .discriminator_arch import UNetDiscriminatorSN
from .femasr_arch import FeMaSRNet, init_weights
from .inference import SRInferencer, load_inferencer
from .swinir_arch import SwinIR
from .vgg_arch import VGGFeatureExtractor

__all__ = ['build_network', 'FeMaSRNet', 'SwinIR', 'UNetDiscriminatorSN',
           'VGGFeatureExtractor', 'init_weights', 'SRInferencer',
           'load_inferencer']


@ARCH_REGISTRY.register(name='FeMaSRNet')
def _femasr_net(**opt) -> FeMaSRNet:
    """FeMaSRNet from a network_g dict: the trainer's keys (the search
    backend, the dtype: the port's FeMaSRNet computes in its input's) are
    not the module's."""
    from ..train.femasr_model import build_generator
    return build_generator(dict(opt, type='FeMaSRNet'))


@ARCH_REGISTRY.register(name='UNetDiscriminatorSN')
def _discriminator(**opt) -> UNetDiscriminatorSN:
    from ..train.femasr_model import build_discriminator
    return build_discriminator(dict(opt, type='UNetDiscriminatorSN'))


ARCH_REGISTRY.register(VGGFeatureExtractor)


def build_network(opt):
    """Instantiate a network from a YAML `network_*` dict: `type` names the
    registered network, `frozen_module_keywords` is the trainer's, and the
    rest are its arguments (`dtype: bfloat16` a compute dtype)."""
    opt = deepcopy(dict(opt))
    network_type = opt.pop('type')
    opt.pop('frozen_module_keywords', None)
    return ARCH_REGISTRY.get(network_type)(**opt)
