"""Evaluate a FeMaSR network with the port:

    python -m femasr_torch.test_cli -opt options/test_FeMaSR.yml

The counterpart of the JAX package's test.py, with its options (YAML, or
JSON without PyYAML; --force_yml as there): the network of
`path.pretrain_network_g` super-resolves every image of each dataset of
the options; the images go to results/<name>/visualization/<dataset>/
under the current directory, and on datasets with GT the `val.metrics`
(psnr, ssim, lpips with `path.pretrain_lpips`, niqe) are logged to
results/<name>/. The run takes the CUDA card and stops without one;
`device: cpu` in the options evaluates on the CPU. Under a launcher
(`torchrun --nproc_per_node N -m femasr_torch.test_cli -opt ... --launcher
pytorch`) the ranks share out the images and give the metrics one
process gives; with `model_parallel: N` the network is split over N
ranks of each data group, which serve their images together.
"""

from __future__ import annotations

import os
import sys

from .train.pipeline import test_pipeline


def main(argv=None, opt=None):
    """Run the evaluation (the options from `-opt` in argv, or the dict
    `opt`); returns the FeMaSRModel, whose `metric_results` hold the last
    dataset's metrics."""
    return test_pipeline(os.getcwd(), argv=argv, opt=opt)


if __name__ == '__main__':
    main(sys.argv[1:])
    from .parallel.dist_util import shutdown
    shutdown()
