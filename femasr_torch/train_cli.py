"""Train FeMaSR with the port:

    python -m femasr_torch.train_cli -opt options/train_FeMaSR_LQ_stage.yml

Options as for the JAX package's train.py (YAML, or JSON without PyYAML);
--auto_resume, --debug and --force_yml as there. Experiments go to
experiments/<name>/ under the current directory. The run takes the CUDA
card and stops without one; `device: cpu` in the options trains on the
CPU. `model_type` must be FeMaSRModel.

Data parallel, one process per card (DistributedDataParallel; each rank
takes batch_size_per_gpu of every global batch):

    torchrun --nproc_per_node 2 -m femasr_torch.train_cli \
        -opt options/train_FeMaSR_LQ_stage.yml --launcher pytorch

or under Slurm, `srun ... python -m femasr_torch.train_cli -opt ...
--launcher slurm`. `--dist_backend gloo` picks gloo over NCCL. With
`model_parallel: N` in the options (`--force_yml model_parallel=N`), the
generator is split over N ranks of each data group (tensor parallelism;
the world size is data x N and each data group takes batch_size_per_gpu).
"""

from __future__ import annotations

import os
import sys

from .train.pipeline import train_pipeline


def main(argv=None, opt=None):
    """Run the training (the options from `-opt` in argv, or the dict
    `opt`); returns the trained FeMaSRModel."""
    return train_pipeline(os.getcwd(), argv=argv, opt=opt)


if __name__ == '__main__':
    main(sys.argv[1:])
    from .parallel.dist_util import shutdown
    shutdown()
