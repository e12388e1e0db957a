"""Building blocks: conv stack (layers), Swin (swin), quantizer (quantize)."""
