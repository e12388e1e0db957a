"""Train FeMaSR with the port:

    python -m femasr_torch.train_cli -opt options/train_FeMaSR_LQ_stage.yml

Options as for the JAX package's train.py (YAML, or JSON without PyYAML);
--auto_resume, --debug and --force_yml as there. Experiments go to
experiments/<name>/ under the current directory. The run takes the CUDA
card and stops without one; `device: cpu` in the options trains on the
CPU. `model_type` must be FeMaSRModel.
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
