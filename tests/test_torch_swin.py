"""The port's swin_tiny detect path against the JAX package: the static tables,
the weight bridge, Swin's four outputs at a size where every pad happens,
and swin_tiny_coco through Yolact and Detector.detect_fixed, in each of the
three block forms ('composed', 'attn_block', 'whole')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models import swin as jax_swin
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.pipeline import Detector as JaxDetector
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models import swin
from yolact_minimal_torch.models.yolact import Yolact
from yolact_minimal_torch.pipeline import Detector, load_detector
from yolact_minimal_torch.utils.weights import (from_jax_variables, load_pth,
                                                swin_from_jax_params)

torch.set_num_threads(1)

# float32 on the CPU on both sides: matrix products and LayerNorm sums run in
# another order, so each output is held to 1e-4 of its own largest magnitude.
REL_TOL = 1e-4
# bf16: each side rounds where its framework does (Dense bias adds, the
# convolutions), so the two are held to 5e-2 of the output's max, as the
# resnet path is.
BF16_REL_TOL = 5e-2
MISMATCH = 1e-4
NAMES = ('class', 'box', 'coef', 'proto')


def _perturb(variables, seed):
    """Random-init biases are 0 and LayerNorm scales 1: noise on every leaf
    so that a dropped bias or a swapped scale shows."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(scale=0.02, size=a.shape).astype(np.float32),
        variables)


def _rel_err(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('hp,wp', [(140, 140), (70, 70), (35, 35), (21, 21), (14, 21)])
def test_static_tables_equal_jax(hp, wp):
    ours, ref = swin.shifted_window_regions(hp, wp), jax_swin.shifted_window_regions(hp, wp)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(swin.relative_position_index(),
                                  jax_swin.relative_position_index())
    x = np.random.RandomState(0).normal(size=(2, hp, wp, 5)).astype(np.float32)
    win = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(swin.window_reverse(win, 7, hp, wp).numpy(), x)


@pytest.mark.parametrize('shift', [0, 3])
@pytest.mark.parametrize('h,hp', [(136, 140), (68, 70), (34, 35), (17, 21), (14, 14)])
def test_pad_rowmask_equals_jax(h, hp, shift):
    w, wp = (9, 14) if h == 17 else (h, hp)             # once with a map that is not square
    ours, ref = swin.pad_rowmask(h, w, hp, wp, shift), jax_swin.pad_rowmask(h, w, hp, wp, shift)
    if h == hp:
        assert ours is None and ref is None             # no padding: the kernel takes None
        return
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ((hp // 7) * (wp // 7), 49)
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() == h * w
    on_device = swin._rowmask_on(h, w, hp, wp, shift, torch.device('cpu'), 7)
    assert on_device is swin._rowmask_on(h, w, hp, wp, shift, torch.device('cpu'), 7)   # cached
    np.testing.assert_array_equal(on_device.numpy(), ref)


# The JAX package's flags for each of the port's fused forms.
JAX_FLAGS = {'attn_block': dict(fused_attn_block=True, fused_mlp=True),
             'whole': dict(fused_whole=True)}


@pytest.mark.parametrize('form', ['attn_block', 'whole'])
def test_stage_forms_match_jax(form):
    """Two blocks (unshifted, shifted) on a 30x26 map that pads to 35x28,
    against the JAX stage run with the same flags on the same variables."""
    dim, heads = 96, 3
    x = np.random.RandomState(9).normal(size=(2, 30, 26, dim)).astype(np.float32)
    kw = dict(dim=dim, depth=2, num_heads=heads, drop_path_rates=(0.0, 0.0), downsample=True)
    v = _perturb(jax.jit(jax_swin.SwinStage(**kw).init)(jax.random.PRNGKey(2), x), 10)
    ref_out, ref_down = jax_swin.SwinStage(**kw, **JAX_FLAGS[form]).apply(v, x)
    sd = {k.removeprefix('layers.0.'): t
          for k, t in swin_from_jax_params({'stage0': v['params']}, prefix='').items()}
    flags = {f: True for f in JAX_FLAGS[form] if f != 'fused_mlp'}
    stage = swin.SwinStage(dim, 2, heads, downsample=True, window=7, **flags)
    stage.load_state_dict(sd, strict=True)
    assert [getattr(b, f) for b in stage.blocks for f in flags] == [True, True]
    assert [b.shift for b in stage.blocks] == [0, 3]
    with torch.no_grad():
        out, down = stage.eval()(torch.from_numpy(x))
    for name, o, r in (('blocks', out, ref_out), ('merged', down, ref_down)):
        assert o.shape == r.shape, name
        err = _rel_err(o.numpy(), np.asarray(r))
        assert err < REL_TOL, f'{name}: relative error {err}'


# 72 px: 18 -> pad 21; merge to 9 -> pad 14; 9 is odd: merge pads to 10 -> 5
# -> pad 7; merge pads to 6 -> 3 -> pad 7. Narrow, head width 32.
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))


@pytest.fixture(scope='module')
def small_swin():
    x = np.random.RandomState(3).normal(size=(2, 72, 72, 3)).astype(np.float32)
    jm = jax_swin.SwinTiny(**SMALL)
    v = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), x), 4)
    return x, v


@pytest.mark.parametrize('fused', [False, True])
def test_swin_tiny_outputs_match_jax(small_swin, fused):
    # fused=True: the JAX package's Pallas kernels, in interpret mode here
    x, v = small_swin
    ref = jax.jit(jax_swin.SwinTiny(**SMALL, fused_attn=fused).apply)(v, x)
    model = swin.Swin(**SMALL)
    model.load_state_dict(swin_from_jax_params(v['params'], prefix=''), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))
    sizes = [(18, 32), (9, 64), (5, 128), (3, 256)]
    for i, (o, r, (hw, c)) in enumerate(zip(ours, ref, sizes)):
        assert o.shape == r.shape == (2, hw, hw, c), i
        err = _rel_err(o.numpy(), np.asarray(r))
        assert err < REL_TOL, f'output {i}: relative error {err}'


@pytest.mark.parametrize('forms', ['attn_block', 'whole',
                                   ('whole', 'attn_block', 'composed', 'whole')])
def test_swin_tiny_forms_match_jax_and_composed(small_swin, forms):
    x, v = small_swin
    ref = jax.jit(jax_swin.SwinTiny(**SMALL, fused_attn=True).apply)(v, x)
    sd = swin_from_jax_params(v['params'], prefix='')
    model = swin.Swin(**SMALL, block_forms=forms)
    composed = swin.Swin(**SMALL)
    assert list(model.state_dict()) == list(composed.state_dict())
    model.load_state_dict(sd, strict=True)
    composed.load_state_dict(sd, strict=True)
    per_stage = [forms] * 4 if isinstance(forms, str) else list(forms)
    for stage, form in zip(model.layers, per_stage):
        assert all((b.fused_attn_block, b.fused_whole) ==
                   (form == 'attn_block', form == 'whole') for b in stage.blocks)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))
        base = composed.eval()(torch.from_numpy(x))
        composed.set_block_forms(forms)                 # the same instance, switched
        switched = composed(torch.from_numpy(x))
    for i, (o, r, b, s) in enumerate(zip(ours, ref, base, switched)):
        assert o.shape == r.shape, i
        assert torch.equal(o, s), i
        for what, other in (('JAX', np.asarray(r)), ('composed', b.numpy())):
            err = _rel_err(o.numpy(), other)
            # on the CPU 'attn_block' runs the composed form's very operations
            assert err < REL_TOL, f'output {i} against {what}: relative error {err}'
    for bad in ('fused', ('whole', 'whole'), ('whole', 'attn_block', 'composed', 'mlp')):
        with pytest.raises(ValueError, match='block forms must be'):
            model.set_block_forms(bad)


def test_derived_tensors_follow_their_parameters(small_swin):
    _, v = small_swin
    model = swin.Swin(**SMALL, dtype=torch.bfloat16)
    block = model.layers[0].blocks[1]
    # calls that need no gradient (the eval path) share one cast per parameter
    # version; calls that do cast afresh, so the gradient reaches the parameters
    with torch.no_grad():
        k1, bias = block.mlp.fc1.cast()[0], block.attn.bias()
        assert k1.dtype == bias.dtype == torch.bfloat16 and bias.shape == (1, 49, 49)
        assert block.mlp.fc1.cast()[0] is k1 and block.attn.bias() is bias    # cached
        assert len(block.attn.qkv.cast()) == 2
        assert len(model.layers[0].downsample.reduction.cast()) == 1
    assert block.mlp.fc1.cast()[0].requires_grad and block.attn.bias().requires_grad
    assert block.mlp.fc1.cast()[0] is not block.mlp.fc1.cast()[0]
    model.load_state_dict(swin_from_jax_params(v['params'], prefix=''), strict=True)
    with torch.no_grad():
        assert torch.equal(block.mlp.fc1.cast()[0], block.mlp.fc1.weight.detach().bfloat16())
        assert not torch.equal(block.mlp.fc1.cast()[0], k1)
        assert torch.equal(block.attn.qkv.cast()[1], block.attn.qkv.bias.detach().bfloat16())
        table = block.attn.relative_position_bias_table.detach()
        idx = torch.from_numpy(swin.relative_position_index().astype(np.int64))
        assert torch.equal(block.attn.bias()[0],
                           table[idx.reshape(-1), 0].reshape(49, 49).bfloat16())
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        assert t.dtype in (torch.float32, torch.int64), name


IMG = 64
CFG = dict(img_size=IMG, nms_pre_topk=128)


@pytest.fixture(scope='module')
def jax_init():
    """swin_tiny_coco at full width, the JAX package's own random init."""
    cfg = jax_config('swin_tiny_coco', fused_window_attn='off', **CFG)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1)))


@pytest.fixture(scope='module')
def jax_variables(jax_init):
    """swin_tiny_coco at full width on one perturbed random init: the noise on
    conf_layer separates the softmax scores (raw, they sit near 1/81 and
    reorder under float noise) without the large logits that would magnify
    the float32 differences of twelve blocks."""
    return _perturb(jax_init, 5)


def test_bridge_covers_every_parameter(jax_variables, tmp_path):
    sd = from_jax_variables(jax_variables)
    model = Yolact(get_config('swin_tiny_coco'))
    assert set(sd) == set(model.state_dict())          # the index buffer is not persistent
    model.load_state_dict(sd, strict=True)
    block = jax_variables['params']['backbone']['stage2']['block5']
    np.testing.assert_array_equal(sd['backbone.layers.2.blocks.5.mlp.fc1.weight'].numpy(),
                                  block['mlp']['fc1']['kernel'].T)
    np.testing.assert_array_equal(
        sd['backbone.layers.2.blocks.5.attn.relative_position_bias_table'].numpy(),
        block['attn']['rel_bias_table'])
    assert sd['backbone.layers.0.downsample.reduction.weight'].shape == (192, 384)
    assert sd['backbone.patch_embed.proj.weight'].shape == (96, 3, 4, 4)
    # a published swin checkpoint carries derived buffers: load_pth drops them
    extra = dict(sd)
    extra['backbone.layers.0.blocks.0.attn.relative_position_index'] = torch.zeros(49, 49)
    extra['backbone.layers.0.blocks.1.attn_mask'] = torch.zeros(4, 49, 49)
    path = tmp_path / 'latest_swin_tiny_coco_10.pth'
    torch.save({'model': extra}, path)
    assert set(load_pth(str(path))) == set(sd)
    det = load_detector(str(path), device='cpu')
    assert det.cfg.backbone == 'swin_tiny'


@pytest.fixture(scope='module')
def jax_forward(jax_variables):
    """The JAX package's swin_tiny_coco forward (Pallas kernels in interpret
    mode) on one seeded batch."""
    img = np.random.RandomState(6).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('swin_tiny_coco', fused_window_attn='on', **CFG))
    return img, jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_variables, img)


@pytest.mark.parametrize('form', ['attn_block', 'whole'])
def test_yolact_forward_forms_match_jax_and_composed(jax_variables, jax_forward, form):
    img, ref = jax_forward
    sd = from_jax_variables(jax_variables)
    model = Yolact(get_config('swin_tiny_coco', **CFG))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        base = model.eval()(torch.from_numpy(img))
        model.backbone.set_block_forms(form)
        assert set(sd) == set(model.state_dict())       # nothing new for the bridge to map
        ours = model(torch.from_numpy(img))
    for name, r, o, b in zip(NAMES, ref, ours, base):
        assert o.shape == r.shape and o.dtype == torch.float32, name
        for what, other in (('JAX', np.asarray(r)), ('composed', b.numpy())):
            err = _rel_err(o.numpy(), other)
            assert err < REL_TOL, f'{name} against {what}: relative error {err}'


@pytest.mark.parametrize('fused', ['off', 'on'])
def test_yolact_forward_matches_jax(jax_variables, fused):
    img = np.random.RandomState(6).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('swin_tiny_coco', fused_window_attn=fused, **CFG))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_variables, img)
    model = Yolact(get_config('swin_tiny_coco', **CFG))
    model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(img))
    for name, r, o in zip(NAMES, ref, ours):
        assert o.shape == r.shape and o.dtype == torch.float32, name
        err = _rel_err(o.numpy(), np.asarray(r))
        assert err < REL_TOL, f'{name}: relative error {err}'


def test_yolact_bf16_forward_matches_jax(jax_init):
    # On the plain random init: with the perturbed weights the activations
    # grow, and the JAX package's own two bf16 paths (Pallas and XLA) already
    # differ by 8e-2 of the coef output's max there; on the plain init all
    # pairs stay near 3e-2.
    jax_variables = jax_init
    img = np.random.RandomState(7).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('swin_tiny_coco', fused_window_attn='on',
                                  compute_dtype='bfloat16', **CFG))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_variables, img)
    sd = from_jax_variables(jax_variables)
    model = Yolact(get_config('swin_tiny_coco', compute_dtype='bfloat16', **CFG))
    model.load_state_dict(sd, strict=True)
    f32 = Yolact(get_config('swin_tiny_coco', **CFG))
    f32.load_state_dict(sd, strict=True)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        assert t.dtype in (torch.float32, torch.int64), name
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(img))
        full = f32.eval()(torch.from_numpy(img))
    for name, r, o, f in zip(NAMES, ref, ours, full):
        assert o.dtype == torch.float32, name
        err = _rel_err(o.numpy(), np.asarray(r))
        assert err < BF16_REL_TOL, f'{name}: relative error {err}'
        assert _rel_err(o.numpy(), f.numpy()) > 0, f'{name}: the network did not run in bf16'


@pytest.fixture(scope='module')
def jax_slate(jax_variables):
    images = np.random.RandomState(8).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jdet = JaxDetector(jax_config('swin_tiny_coco', fused_window_attn='on', **CFG),
                       jax_variables, static_weights=False)
    return images, jdet.detect_fixed(jnp.asarray(images), IMG)


@pytest.mark.parametrize('form', ['composed', 'attn_block', 'whole'])
def test_detect_fixed_matches_jax(jax_variables, jax_slate, form):
    images, (ref, ref_masks) = jax_slate
    det = Detector(get_config('swin_tiny_coco', **CFG), from_jax_variables(jax_variables),
                   device='cpu')
    assert not any(b.fused_attn_block or b.fused_whole
                   for stage in det.model.backbone.layers for b in stage.blocks)
    det.model.backbone.set_block_forms(form)
    ours, masks = det.detect_fixed(images, IMG)
    assert ours.valid.sum() > 10
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-5)
    assert masks.dtype == torch.bool and masks.shape == (2, 100, IMG, IMG)
    assert np.asarray(ref_masks).any()
    assert (masks.numpy() != np.asarray(ref_masks)).mean() < MISMATCH


def test_swin_random_init_is_seeded():
    cfg = get_config('swin_tiny_coco', img_size=IMG)
    a, b = Yolact(cfg), Yolact(cfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    block = a.backbone.layers[1].blocks[0]
    for w in (block.attn.qkv.weight, block.mlp.fc2.weight,
              block.attn.relative_position_bias_table):
        assert 0.015 < float(w.detach().std()) < 0.025 and float(w.detach().abs().max()) < 0.2
    assert not block.attn.qkv.bias.any() and not block.mlp.fc1.bias.any()
    assert torch.equal(block.norm2.weight, torch.ones(192))
