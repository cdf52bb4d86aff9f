"""The port's `.ckpt` reader and writer against the JAX package and flax:
checkpoints the JAX package writes load strictly into the port, checkpoints
the port writes are what flax reads back, and the port's own msgpack codec
reads every msgpack type that msgpack and flax write."""
import os
import tempfile

import flax.serialization as fser
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import msgpack as msgpack_lib
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings

from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.utils import checkpoint as jax_ckpt
from yolact_minimal_tpu.utils.weights import convert_state_dict
from yolact_minimal_torch.config import cfg_name_from_weight, get_config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.pipeline import load_detector
from yolact_minimal_torch.utils import checkpoint, msgpack
from yolact_minimal_torch.utils.weights import from_jax_variables, load_pth, to_jax_variables

torch.set_num_threads(1)

CONFIGS = ('res50_custom', 'res101_custom', 'swin_tiny_custom')


@pytest.fixture(scope='module')
def jax_init():
    """Each config's JAX random init (the tree does not depend on img_size)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = jax_config(name, img_size=64, fused_window_attn='off')
            init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
                key, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
            cache[name] = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3)))
        return cache[name]
    return get


def _assert_trees_equal(ours, ref, path=''):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), path
        for k in ref:
            _assert_trees_equal(ours[k], ref[k], f'{path}/{k}')
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and ours == ref, path


def _assert_state_dicts_equal(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


@pytest.mark.parametrize('name', CONFIGS)
def test_jax_checkpoint_loads_strictly_into_the_port(jax_init, tmp_path, name):
    variables = jax_init(name)
    path = str(tmp_path / f'best_12.5_{name}_300.ckpt')
    jax_ckpt.save_checkpoint(path, variables)
    # the codec reads the file as flax does
    _assert_trees_equal(checkpoint.load_checkpoint(path), jax_ckpt.load_checkpoint(path))
    sd = checkpoint.load_weights_auto(path)
    _assert_state_dicts_equal(sd, from_jax_variables(variables))
    model = Yolact(get_config(name, img_size=64))
    model.load_state_dict(sd, strict=True)
    # load_weights_auto is the one reader of a .ckpt: load_pth refuses it and
    # names it; load_detector reads the config from the file name
    with pytest.raises(ValueError, match='load_weights_auto'):
        load_pth(path)
    det = load_detector(path, device='cpu')
    assert det.cfg.name == name
    _assert_state_dicts_equal({k: v for k, v in det.model.state_dict().items()
                               if k in sd}, sd)


@pytest.mark.parametrize('name', ['res50_custom', 'swin_tiny_custom'])
def test_latest_payload_loads_through_load_weights_auto(jax_init, tmp_path, name):
    variables = jax_init(name)
    params = dict(variables['params'])
    params['semantic_seg_conv'] = {'kernel': np.ones((1, 1, 256, 4), np.float32),
                                   'bias': np.zeros(4, np.float32)}
    opt = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(1e-3, momentum=0.9))
    payload = {'params': params,
               # swin has no BatchNorm: training stores None
               'batch_stats': variables.get('batch_stats'),
               'opt_state': fser.to_state_dict(jax.device_get(opt.init(params))),
               'step': 2000 if name.startswith('res') else np.int64(2000)}
    assert (payload['batch_stats'] is None) == name.startswith('swin')
    path = jax_ckpt.save_latest(payload, name, 2000, weight_dir=str(tmp_path))
    assert os.path.basename(path) == f'latest_{name}_2000.ckpt'
    raw = checkpoint.load_checkpoint(path)
    assert set(raw) == {'params', 'batch_stats', 'opt_state', 'step'}
    assert raw['step'] == 2000
    sd = checkpoint.load_weights_auto(path)
    _assert_state_dicts_equal(sd, from_jax_variables(variables))
    Yolact(get_config(name, img_size=64)).load_state_dict(sd, strict=True)


@pytest.mark.parametrize('name', CONFIGS)
def test_port_checkpoint_is_what_flax_reads(jax_init, tmp_path, name):
    sd = from_jax_variables(jax_init(name))
    variables = to_jax_variables(sd)
    path = str(tmp_path / f'latest_{name}_7.ckpt')
    checkpoint.save_checkpoint(path, variables)
    with open(path, 'rb') as f:
        restored = fser.msgpack_restore(f.read())
    _assert_trees_equal(restored, convert_state_dict({k: v.numpy() for k, v in sd.items()}))
    # and back: the JAX package's loader, then the port's
    _assert_trees_equal(jax_ckpt.load_weights_auto(path, include_semantic=False), restored)
    _assert_state_dicts_equal(checkpoint.load_weights_auto(path), sd)


def test_to_jax_variables_inverts_from_jax_variables(jax_init):
    for name in CONFIGS:
        v = jax_init(name)
        _assert_trees_equal(to_jax_variables(from_jax_variables(v)), v)


def test_filename_contract_matches_jax(tmp_path):
    variables = {'params': {'layer': {'kernel': np.arange(6, dtype=np.float32).reshape(2, 3)}},
                 'batch_stats': {'bn': {'mean': np.ones(3, np.float32)}}}
    for pkg, wd in ((checkpoint, tmp_path / 'port'), (jax_ckpt, tmp_path / 'jax')):
        wd = str(wd)
        p1 = pkg.save_best(variables, 10.5, 'res50_coco', 100, weight_dir=wd)
        assert pkg.save_best(variables, 9.0, 'res50_coco', 200, weight_dir=wd) is None
        p2 = pkg.save_best(variables, 11.25, 'res50_coco', 300, weight_dir=wd)
        assert not os.path.exists(p1) and os.path.exists(p2)
        l1 = pkg.save_latest(variables, 'res50_coco', 100, weight_dir=wd)
        l2 = pkg.save_latest(variables, 'res50_coco', 200, weight_dir=wd)
        assert not os.path.exists(l1) and os.path.exists(l2)
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax')) == \
        ['best_11.25_res50_coco_300.ckpt', 'latest_res50_coco_200.ckpt']
    for name in sorted(os.listdir(tmp_path / 'port')):
        with open(tmp_path / 'port' / name, 'rb') as a, open(tmp_path / 'jax' / name, 'rb') as b:
            assert a.read() == b.read(), name
    for path in ('weights/best_30.5_res101_coco_392000.ckpt', 'latest_res50_custom_25.ckpt',
                 'best_0.0_swin_tiny_custom_8.ckpt', 'weights/best_28.8_res50_coco_800000.pth'):
        assert checkpoint.step_from_name(path) == jax_ckpt.step_from_name(path)
    for path, name in (('weights/best_30.5_res101_coco_392000.ckpt', 'res101_coco'),
                       ('best_41.07_res50_custom_1500.ckpt', 'res50_custom'),
                       ('latest_res101_custom_2000.ckpt', 'res101_custom'),
                       ('latest_swin_tiny_custom_100.ckpt', 'swin_tiny_custom')):
        assert cfg_name_from_weight(path) == name
    with pytest.raises(ValueError, match='No step'):
        checkpoint.step_from_name('weights.ckpt')


# --- the codec ------------------------------------------------------------------

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _every_width_tree(rng):
    tree = {'ints': INT_EDGES, 'none': None, 'bools': [True, False],
            'floats': [0.0, -1.5, 1e300, float(rng.normal())],
            'str': {str(n): 'ü' * (n // 2) + 'a' * (n % 2) for n in LENGTHS},
            'bin': {str(n): rng.bytes(n) for n in LENGTHS},
            'arrays': {str(n): list(range(n)) for n in (0, 15, 16, 65536)},
            'maps': {str(n): {f'k{i}': i for i in range(n)} for n in (0, 15, 16, 65536)},
            'ext': [msgpack_lib.ExtType(5, rng.bytes(n)) for n in (1, 2, 4, 8, 16, 3, 255, 256,
                                                                   65536)]}
    return tree


def _plain(x):
    """msgpack's ExtType as the port's, for comparison."""
    if isinstance(x, msgpack_lib.ExtType):
        return msgpack.ExtType(x.code, x.data)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize('single_float', [False, True])
def test_codec_reads_every_msgpack_width(single_float):
    tree = _every_width_tree(np.random.RandomState(0))
    data = msgpack_lib.packb(tree, use_bin_type=True, use_single_float=single_float)
    ref = msgpack_lib.unpackb(data, raw=False, strict_map_key=False)
    assert msgpack.unpackb(data) == _plain(ref)
    # old-style raw strings: bytes come back as the str family
    raw = msgpack_lib.packb({'s': 'abc', 'n': [1, -200]}, use_bin_type=False)
    assert msgpack.unpackb(raw) == {'s': 'abc', 'n': [1, -200]}


def test_codec_writes_what_msgpack_reads():
    tree = _every_width_tree(np.random.RandomState(1))
    for kind in ('ext', 'floats'):                      # nothing a checkpoint writes
        tree.pop(kind)
    data = msgpack.packb(tree)
    assert msgpack_lib.unpackb(data, raw=False, strict_map_key=False) == tree
    assert data == msgpack_lib.packb(tree, use_bin_type=True)      # the same bytes
    assert msgpack.unpackb(data) == tree
    with pytest.raises(ValueError, match='ends inside'):
        msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match='after the msgpack value'):
        msgpack.unpackb(data + b'\xc0')


_leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.text(max_size=40) | st.binary(max_size=40))
_trees = st.recursive(_leaves | st.floats(allow_nan=False),
                      lambda inner: st.lists(inner, max_size=5)
                      | st.dictionaries(st.text(max_size=8), inner, max_size=5), max_leaves=30)
_written = st.recursive(_leaves, lambda inner: st.lists(inner, max_size=5)
                        | st.dictionaries(st.text(max_size=8), inner, max_size=5), max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_codec_reads_msgpack_trees(tree):
    data = msgpack_lib.packb(tree, use_bin_type=True)
    assert msgpack.unpackb(data) == msgpack_lib.unpackb(data, raw=False)


@settings(max_examples=150, deadline=None)
@given(_written)
def test_codec_writes_msgpack_trees(tree):
    assert msgpack.packb(tree) == msgpack_lib.packb(tree, use_bin_type=True)


@settings(max_examples=40, deadline=None)
@given(st.sampled_from(['float32', 'float64', 'int8', 'uint8', 'int16', 'int32', 'int64',
                        'uint32', 'bool', 'float16', 'complex64']),
       st.lists(st.integers(0, 5), max_size=3), st.integers(0, 2 ** 31 - 1))
def test_codec_reads_flax_arrays(dtype, shape, seed):
    a = (np.random.RandomState(seed).normal(size=shape) * 50).astype(dtype)
    tree = {'a': a, 'nested': {'s': a.reshape(-1)[:1].copy(), 'step': np.int64(seed)}}
    data = fser.msgpack_serialize(tree)
    got = msgpack.unpackb(data)
    _assert_trees_equal(got, fser.msgpack_restore(data))
    assert isinstance(got['nested']['step'], np.int64)
    # what the JAX package's save_checkpoint writes, the port's writes
    with tempfile.TemporaryDirectory() as tmp:
        jax_ckpt.save_checkpoint(f'{tmp}/a.ckpt', tree)
        checkpoint.save_checkpoint(f'{tmp}/b.ckpt', got)
        with open(f'{tmp}/a.ckpt', 'rb') as a, open(f'{tmp}/b.ckpt', 'rb') as b:
            assert a.read() == b.read()


def test_codec_reads_chunked_arrays_bf16_and_scalars(monkeypatch):
    rng = np.random.RandomState(2)
    big = rng.normal(size=(10, 7)).astype(np.float32)         # 280 bytes, 5 chunks of 64
    small = rng.normal(size=(3,)).astype(np.float32)
    bf16 = jnp.asarray(rng.normal(size=(4, 5)), jnp.bfloat16)
    tree = {'params': {'big': big, 'small': small, 'bf16': bf16},
            'step': np.int64(25), 'c': 1.5 - 2j, 'f': np.float32(0.25)}
    monkeypatch.setattr(fser, 'MAX_CHUNK_SIZE', 64)
    data = fser.msgpack_serialize(tree)
    assert b'__msgpack_chunked_array__' in data
    got = msgpack.unpackb(data)
    np.testing.assert_array_equal(got['params']['big'], big)
    np.testing.assert_array_equal(got['params']['small'], small)
    t = got['params']['bf16']
    assert t.dtype == torch.bfloat16 and t.shape == (4, 5)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(bf16).view(np.int16))
    assert got['step'] == 25 and isinstance(got['step'], np.int64)
    assert got['c'] == 1.5 - 2j and got['f'] == np.float32(0.25)
