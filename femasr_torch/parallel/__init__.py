"""Multi-device runs of the port: process groups (`dist_util`), the
('data', 'model') mesh with batch sharding and the tensor-parallel layout
(`mesh`), and the split layers and collectives of the 'model' axis
(`tensor_parallel`)."""

from .dist_util import (barrier, get_dist_info, init_dist, is_dist,
                        master_only)
from .mesh import create_mesh, gather_batch, is_main_process, local_slice
from .tensor_parallel import ModelAxis, model_axis

__all__ = ['ModelAxis', 'barrier', 'create_mesh', 'gather_batch',
           'get_dist_info', 'init_dist', 'is_dist', 'is_main_process',
           'local_slice', 'master_only', 'model_axis']
