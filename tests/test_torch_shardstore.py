"""The port's `.fmrs` shard store against the JAX package's, on one set of
seeded images: the port's C++ reader (`csrc/shardstore.cpp`, built with
g++), its numpy twin (`PlainShardReader`) and the JAX package's C++ reader
give the same keys, meta, bytes and augmented batches bit for bit; each
package reads the other's shards; both refuse the same broken files; a
failed build raises. Also the storage facades (`FileClient`,
`lmdb_util`) against the JAX package's."""

import os
import struct

import cv2
import numpy as np
import pytest

from femasr_torch.data import shardstore as port
from femasr_torch.kernels import _build
from femasr_torch.utils import file_client as port_fc
from femasr_torch.utils import lmdb_util as port_lmdb
from femasr_tpu import native as jax_native
from femasr_tpu.utils import file_client as jax_fc
from femasr_tpu.utils import lmdb_util as jax_lmdb

SIZES = [(40, 36), (33, 52), (24, 24), (64, 40), (31, 29)]


@pytest.fixture(scope='module', autouse=True)
def jax_native_cache(tmp_path_factory):
    """The JAX package's reader: g++ writes its library straight to its
    cache path, so a cache of this module's own keeps two test processes
    from writing one library at the same time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('FEMASR_NATIVE_CACHE',
                  str(tmp_path_factory.mktemp('jax_native')))
        yield


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('imgs')
    rng = np.random.default_rng(0)
    os.makedirs(root / 'sub')
    for i, (h, w) in enumerate(SIZES):
        sub = 'sub/' if i % 2 else ''
        cv2.imwrite(str(root / f'{sub}im{i}.png'),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(root)


@pytest.fixture(scope='module')
def shards(folder, tmp_path_factory):
    out = tmp_path_factory.mktemp('shards')
    a, b = str(out / 'port.fmrs'), str(out / 'jax.fmrs')
    assert port.make_shard_from_folder(folder, a) == len(SIZES)
    assert jax_native.make_shard_from_folder(folder, b) == len(SIZES)
    assert jax_native.native_available(), 'the JAX reader fell back to numpy'
    return a, b


def _readers(path):
    return (port.ShardStoreReader(path), port.PlainShardReader(path),
            jax_native.ShardStoreReader(path))


def test_writers_write_the_same_bytes(shards):
    a, b = shards
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize('which', ['port', 'jax'])
def test_readers_agree_on_keys_meta_and_bytes(shards, which):
    path = shards[0 if which == 'port' else 1]
    native, plain, ref = _readers(path)
    assert len(native) == len(plain) == len(ref) == len(SIZES)
    assert native.keys() == plain.keys() == ref.keys() == [
        'im0', 'im2', 'im4', 'sub/im1', 'sub/im3']
    for i in range(len(ref)):
        assert native.meta(i) == plain.meta(i) == tuple(ref.meta(i))
        want = ref.read(i)
        assert want.shape == (*ref.meta(i)[:2], 3)
        assert np.array_equal(native.read(i), want)
        assert np.array_equal(plain.read(i), want)


@pytest.mark.parametrize('flags', [(True, True, True), (True, False, False),
                                   (False, True, True), (False, False, False)],
                         ids=['all', 'hflip', 'vflip_rot', 'none'])
@pytest.mark.parametrize('seed', [0, 12345, 2 ** 63 + 17])
def test_sample_batch_matches_jax_bit_for_bit(shards, flags, seed):
    native, plain, ref = _readers(shards[0])
    idx = [0, 3, 3, 1, 4, 2, 0, 1]
    want = ref.sample_batch(idx, 20, *flags, seed=seed)
    assert want.shape == (len(idx), 20, 20, 3)
    assert np.array_equal(native.sample_batch(idx, 20, *flags, seed=seed),
                          want)
    assert np.array_equal(plain.sample_batch(idx, 20, *flags, seed=seed),
                          want)
    # a whole-image crop draws nothing but the flips
    assert np.array_equal(native.sample_batch([1], 24, *flags, seed=seed),
                          ref.sample_batch([1], 24, *flags, seed=seed))


def test_sample_batch_refusals_agree(shards):
    native, plain, ref = _readers(shards[0])
    for reader in (native, plain, ref):
        with pytest.raises(ValueError, match='crop must be positive'):
            reader.sample_batch([0], 0)
        with pytest.raises(RuntimeError, match='-3'):   # crop > the image
            reader.sample_batch([1], 25)
        with pytest.raises(RuntimeError, match='-1'):   # no such item
            reader.sample_batch([len(SIZES)], 8)


def _entry(blob: bytes, i: int) -> list:
    at = port.HEADER_BYTES + i * port.ENTRY.size
    return list(port.ENTRY.unpack(blob[at:at + port.ENTRY.size]))


def _with_entry(blob: bytes, i: int, field: int, value) -> bytes:
    e = _entry(blob, i)
    e[field] = value
    at = port.HEADER_BYTES + i * port.ENTRY.size
    return blob[:at] + port.ENTRY.pack(*e) + blob[at + port.ENTRY.size:]


BROKEN = {
    'truncated': lambda b: b[:-1],
    'header_only': lambda b: b[:12],
    'empty': lambda b: b'',
    'bad_magic': lambda b: b'FMRS2' + b[5:],
    'too_many_items': lambda b: b[:8] + struct.pack('<Q', 2 ** 60) + b[16:],
    'offset_in_index': lambda b: _with_entry(b, 1, 0, 16),
    'offset_past_end': lambda b: _with_entry(b, 0, 0, len(b) + 1),
    'side_too_large': lambda b: _with_entry(b, 2, 1, (1 << 21) + 1),
    'too_many_channels': lambda b: _with_entry(b, 3, 3, 17),
}


@pytest.mark.parametrize('case', sorted(BROKEN))
def test_broken_shards_are_refused_alike(shards, tmp_path, case):
    with open(shards[0], 'rb') as f:
        blob = BROKEN[case](f.read())
    path = str(tmp_path / 'broken.fmrs')
    with open(path, 'wb') as f:
        f.write(blob)
    with pytest.raises(IOError):
        port.ShardStoreReader(path)
    with pytest.raises(IOError):
        port.PlainShardReader(path)
    with pytest.raises((IOError, AssertionError)):
        jax_native.ShardStoreReader(path)


def test_writer_guards_and_abort(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    path = str(tmp_path / 'w.fmrs')
    for writer in (port.ShardStoreWriter(path),
                   jax_native.ShardStoreWriter(path)):
        with pytest.raises(ValueError, match='63'):
            writer.add('k' * 64, img)
        writer.abort()
    with pytest.raises(ValueError, match='too large'):
        port.ShardStoreWriter(path).add('k', np.zeros((1, 1, 17), np.uint8))
    with pytest.raises(ValueError, match='uint8'):
        port.ShardStoreWriter(path).add('k', img.astype(np.float32))
    with pytest.raises(ValueError, match='.fmrs'):
        port.ShardStoreWriter(str(tmp_path / 'w.lmdb'))
    with pytest.raises(KeyError):
        with port.ShardStoreWriter(path) as w:
            w.add('a', img)
            raise KeyError('stop')
    assert not os.listdir(tmp_path)       # no shard, no spool
    with port.ShardStoreWriter(path) as w:
        w.add('k' * 63, img + 7)
    r = port.ShardStoreReader(path)
    assert r.keys() == ['k' * 63] and int(r.read(0).max()) == 7


def test_failed_build_raises(tmp_path, monkeypatch):
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'shardstore.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(_build, 'CSRC', str(csrc))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(port, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        port.ShardStoreReader(str(tmp_path / 'any.fmrs'))
    assert not os.listdir(tmp_path / 'build')   # no half-written library


def test_file_client_matches_jax(shards, folder):
    a = shards[0]
    for backend in ('shard', 'lmdb'):
        ours = port_fc.FileClient(backend, db_paths=[a], client_keys=['gt'])
        ref = jax_fc.FileClient(backend, db_paths=[a], client_keys=['gt'])
        for key in ('im0', 'sub/im3'):
            assert np.array_equal(ours.get(key, 'gt'), ref.get(key, 'gt'))
    disk = port_fc.FileClient('disk')
    path = os.path.join(folder, 'im2.png')
    assert disk.get(path) == jax_fc.FileClient('disk').get(path)
    with pytest.raises(ImportError):
        port_fc.FileClient('memcached', server_list_cfg=None, client_cfg=None)
    with pytest.raises(ValueError, match='not supported'):
        port_fc.FileClient('petrel')


def test_lmdb_util_matches_jax(folder, tmp_path):
    ours = port_lmdb.make_lmdb_from_imgs(folder, str(tmp_path / 'a.lmdb'))
    ref = jax_lmdb.make_lmdb_from_imgs(folder, str(tmp_path / 'b.lmdb'))
    assert ours.endswith('a.fmrs') and ref.endswith('b.fmrs')
    for suffix in ('', '.meta_info.txt'):
        with open(ours + suffix, 'rb') as f, open(ref + suffix, 'rb') as g:
            assert f.read() == g.read(), suffix
    # LmdbMaker: encoded bytes and raw arrays
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (9, 7, 3), dtype=np.uint8) for _ in range(2)]
    made = []
    for mod, name in ((port_lmdb, 'c.lmdb'), (jax_lmdb, 'd.lmdb')):
        maker = mod.LmdbMaker(str(tmp_path / name))
        maker.put(cv2.imencode('.png', imgs[0])[1].tobytes(), 'enc', None)
        maker.put(imgs[1], 'raw', None)
        maker.close()
        made.append(maker.lmdb_path)
    for suffix in ('', '.meta_info.txt'):
        with open(made[0] + suffix, 'rb') as f, open(made[1] + suffix,
                                                     'rb') as g:
            assert f.read() == g.read(), suffix
    r = port.ShardStoreReader(made[0])
    assert np.array_equal(r.read(0), imgs[0][..., ::-1])   # decoded BGR
    assert np.array_equal(r.read(1), imgs[1])
