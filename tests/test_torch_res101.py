"""res101_coco in the port against the JAX package: the weight bridge, the
forward and the Detector's slate on one set of weights carried across by
`from_jax_variables`, at the small image size of test_torch_model.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_tpu.utils.weights import to_torch_state_dict
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.utils.weights import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

IMG = 64
CFG = dict(img_size=IMG, nms_pre_topk=128)
# float32 on the CPU on both sides, as in test_torch_model.py: each network
# output within 1e-4 of its largest magnitude; slates of two forward passes
# within 1e-5, as in test_torch_pipeline.py.
REL_TOL = 1e-4
SLATE_ATOL = 1e-5


@pytest.fixture(scope='module')
def jax_variables():
    """The JAX package's res101_coco init, conf_layer scaled x20 so that the
    softmax scores separate (with the raw init they sit near 1/81 and
    reorder under float noise)."""
    cfg = jax_config('res101_coco', **CFG)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5)))
    v['params']['prediction_layers']['conf_layer']['kernel'] = \
        v['params']['prediction_layers']['conf_layer']['kernel'] * 20
    return v


def test_bridge_covers_every_res101_parameter(jax_variables):
    sd = from_jax_variables(jax_variables)
    model = Yolact(get_config('res101_coco'))
    assert set(sd) == {k for k in model.state_dict() if not k.endswith('num_batches_tracked')}
    assert sum(k.startswith('backbone.layers.2.') and k.endswith('conv1.weight')
               for k in sd) == 23                               # ResNet-101's 23 blocks
    ref = to_torch_state_dict(jax_variables)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    model.load_state_dict(sd, strict=True)
    assert set(to_jax_variables(sd)['params']['backbone']) == \
        set(jax_variables['params']['backbone'])


def test_res101_forward_and_slate_match_jax(jax_variables):
    images = np.random.RandomState(7).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jcfg = jax_config('res101_coco', **CFG)
    jdet = JaxDetector(jcfg, jax_variables, static_weights=False)
    det = Detector(get_config('res101_coco', **CFG), from_jax_variables(jax_variables),
                   device='cpu')

    ref = jax.jit(lambda v, x: JaxYolact(cfg=jcfg).apply(v, x, train=False))(
        jax_variables, images)
    with torch.no_grad():
        ours = det.model(torch.from_numpy(images))
    for name, r, o in zip(('class', 'box', 'coef', 'proto'), ref, ours):
        r, o = np.asarray(r), o.numpy()
        assert o.shape == r.shape and o.dtype == np.float32, name
        err = np.abs(o - r).max() / np.abs(r).max()
        assert err < REL_TOL, f'{name}: relative error {err}'

    ref_dets, ref_masks, _ = jdet(jnp.asarray(images))
    dets, masks, _ = det(images)
    assert dets.valid.sum() > 10
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(ref_dets.valid))
    np.testing.assert_array_equal(dets.ids.numpy(), np.asarray(ref_dets.ids))
    for field in ('scores', 'boxes', 'coefs'):
        np.testing.assert_allclose(getattr(dets, field).numpy(),
                                   np.asarray(getattr(ref_dets, field)),
                                   rtol=0, atol=SLATE_ATOL, err_msg=field)
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref_masks), rtol=0, atol=1e-4)
