"""res50_coco forward of the port against the JAX package, on one set of
weights carried across by the weight bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import CONFIG_REGISTRY as JAX_REGISTRY
from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.utils.weights import to_torch_state_dict
from yolact_minimal_torch.config import CONFIG_REGISTRY, cfg_name_from_weight, get_config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.ops.boxes import make_anchors
from yolact_minimal_torch.pipeline import Detector, load_detector
from yolact_minimal_torch.utils.weights import from_jax_variables, load_pth

torch.set_num_threads(1)

# float32 on the CPU on both sides; convolutions sum in another order, so
# each output is held to 1e-4 of its own largest magnitude (observed ~3e-6).
REL_TOL = 1e-4


@pytest.fixture(scope='module')
def jax_variables():
    # The parameter tree does not depend on img_size: init once at 64 px.
    cfg = jax_config('res50_coco', img_size=64)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


def test_bridge_covers_every_parameter(jax_variables):
    sd = from_jax_variables(jax_variables)
    model = Yolact(get_config('res50_coco'))
    ours = {k for k in model.state_dict() if not k.endswith('num_batches_tracked')}
    assert set(sd) == ours
    # the same names as the JAX package's own reverse converter emits
    assert set(sd) == set(to_torch_state_dict(jax_variables))
    for k, v in to_torch_state_dict(jax_variables).items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


@pytest.mark.parametrize('img_size', [64, 128])
def test_forward_matches_jax(jax_variables, img_size):
    img = np.random.RandomState(img_size).normal(size=(2, img_size, img_size, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('res50_coco', img_size=img_size))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_variables, img)

    model = Yolact(get_config('res50_coco', img_size=img_size))
    model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(img))

    a = len(make_anchors(img_size, (1.0, 0.5, 2.0), (24, 48, 96, 192, 384)))
    shapes = [(2, a, 81), (2, a, 4), (2, a, 32), (2, img_size // 4, img_size // 4, 32)]
    for name, r, o, shape in zip(('class', 'box', 'coef', 'proto'), ref, ours, shapes):
        r, o = np.asarray(r), o.numpy()
        assert o.shape == r.shape == shape, name
        assert o.dtype == np.float32
        err = np.abs(o - r).max() / np.abs(r).max()
        assert err < REL_TOL, f'{name}: relative error {err}'


def test_bf16_forward_matches_jax(jax_variables):
    # compute_dtype bfloat16 on both sides: convolutions in bf16, parameters
    # and BatchNorm statistics in float32. Each side rounds at its own
    # places (~1e-2 of each output's max against its own float32 run), so
    # the two are held to 5e-2 of the output's max.
    img = np.random.RandomState(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('res50_coco', img_size=64, compute_dtype='bfloat16'))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_variables, img)

    model = Yolact(get_config('res50_coco', img_size=64, compute_dtype='bfloat16'))
    model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(img))
    for name, r, o in zip(('class', 'box', 'coef', 'proto'), ref, ours):
        r, o = np.asarray(r), o.numpy()
        assert o.dtype == r.dtype == np.float32, name
        err = np.abs(o - r).max() / np.abs(r).max()
        assert err < 5e-2, f'{name}: relative error {err}'


def test_bf16_detector_keeps_float32_state():
    det = Detector(get_config('res50_coco', img_size=64, compute_dtype='bfloat16'),
                   device='cpu', seed=1)
    for name, t in list(det.model.named_parameters()) + list(det.model.named_buffers()):
        assert t.dtype in (torch.float32, torch.int64), name
    img = torch.from_numpy(np.random.RandomState(6).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        bf16 = det.model(img)
        det.cfg.compute_dtype = 'float32'
        f32 = det.model(img)
    for name, a, b in zip(('class', 'box', 'coef', 'proto'), bf16, f32):
        assert a.dtype == torch.float32, name
        err = ((a - b).abs().max() / b.abs().max()).item()
        # the network did run in bf16 (not equal), within bf16 rounding
        assert 0 < err < 5e-2, f'{name}: relative error {err}'


def test_pth_round_trip_loads_strict(jax_variables, tmp_path):
    sd = from_jax_variables(jax_variables)
    sd['semantic_seg_conv.weight'] = torch.zeros(80, 256, 1, 1)   # train-only head
    path = tmp_path / 'latest_res50_coco_10.pth'
    torch.save({'model': sd}, path)
    loaded = load_pth(str(path))
    assert 'semantic_seg_conv.weight' not in loaded
    det = load_detector(str(path), device='cpu')
    assert det.cfg.name == 'res50_coco'
    for k, v in det.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, sd[k]), k


def test_random_init_is_seeded():
    cfg = get_config('res50_coco', img_size=64)
    a, b = Yolact(cfg), Yolact(cfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.prediction_layers.conf_layer.weight.detach()
    bound = (6 / (w.shape[1] * 9 + w.shape[0] * 9)) ** 0.5        # Xavier-uniform
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    assert not a.prediction_layers.conf_layer.bias.any()


@pytest.mark.parametrize('name', sorted(JAX_REGISTRY))
def test_config_copy_matches_jax(name):
    # every field the port keeps has the JAX package's value; the JAX-only
    # knob fused_window_attn is the only field left out
    assert set(CONFIG_REGISTRY) == set(JAX_REGISTRY)
    ours, ref = vars(get_config(name, img_size=256)), vars(jax_config(name, img_size=256))
    assert set(ref) - set(ours) == {'fused_window_attn'}
    assert set(ours) <= set(ref)
    for k, v in ours.items():
        assert v == ref[k], k
    assert cfg_name_from_weight(f'weights/best_30.5_{name}_1200.pth') == name
