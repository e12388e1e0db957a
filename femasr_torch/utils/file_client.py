"""Storage backends behind one facade (counterpart of
femasr_tpu/utils/file_client.py): `disk` reads files' bytes, `shard` reads
images of `.fmrs` shards by key (`lmdb` is its alias: the shard store
takes LMDB's place), `memcached` is refused."""

from __future__ import annotations

from typing import Dict


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, 'rb') as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, 'r') as f:
            return f.read()


class ShardBackend:
    """HWC uint8 images of one or more shards, by key; `client_keys` name
    the shards of `db_paths`."""

    def __init__(self, db_paths, client_keys='default', **kwargs):
        from ..data.shardstore import ShardStoreReader
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        assert len(client_keys) == len(db_paths)
        self._readers: Dict[str, ShardStoreReader] = {}
        self._index: Dict[str, Dict[str, int]] = {}
        for ck, path in zip(client_keys, db_paths):
            reader = ShardStoreReader(path)
            self._readers[ck] = reader
            self._index[ck] = {k: i for i, k in enumerate(reader.keys())}

    def get(self, filepath: str, client_key: str = 'default'):
        return self._readers[client_key].read(
            self._index[client_key][str(filepath)])


class MemcachedBackend:
    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        raise ImportError('memcached backend requires pymemcache/mc; '
                          'use disk or shard backends.')


class FileClient:
    """Dispatch to a backend: disk | shard (lmdb) | memcached."""

    _backends = {'disk': DiskBackend, 'shard': ShardBackend,
                 'lmdb': ShardBackend, 'memcached': MemcachedBackend}

    def __init__(self, backend: str = 'disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. '
                             f'Currently supported ones are '
                             f'{list(self._backends.keys())}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = 'default'):
        if self.backend in ('shard', 'lmdb'):
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)
