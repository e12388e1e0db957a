"""Data-parallel runs of the port: process groups (`dist_util`) and the
('data', 'model') mesh with batch sharding (`mesh`)."""

from .dist_util import (barrier, get_dist_info, init_dist, is_dist,
                        master_only)
from .mesh import create_mesh, gather_batch, is_main_process, local_slice

__all__ = ['barrier', 'create_mesh', 'gather_batch', 'get_dist_info',
           'init_dist', 'is_dist', 'is_main_process', 'local_slice',
           'master_only']
