"""Export on the CPU: the four swin kernels as registered operators
(`torch.library.opcheck`, and each CPU implementation against its plain
version), a res50 artifact against the JAX package's forward, a batch-3
artifact against the batch-1 one, meta.json and anchors.npy, swin artifacts
that call all four `yolact_torch::` operators (float32, and bf16 equal to the
live bf16 model), the artifact loaded without `models/`, and the export CLI
and the driver as a user runs them."""
import contextlib
import io
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_minimal_tpu.config import get_config as jax_config
from yolact_minimal_tpu.models.yolact import Yolact as JaxYolact
from yolact_minimal_tpu.ops.boxes import make_anchors as jax_make_anchors
from yolact_minimal_torch import deploy
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.models import swin
from yolact_minimal_torch.ops import attn_block, swin_block, swin_mlp, window_attention
from yolact_minimal_torch.pipeline import Detector
from yolact_minimal_torch.utils import image_io
from yolact_minimal_torch.utils.checkpoint import save_checkpoint
from yolact_minimal_torch.utils.weights import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
IMG = 128
# float32 on the CPU on both sides: convolutions sum in another order, so each
# output is held to 1e-4 of its own largest magnitude, as tests/test_torch_model.py
# holds the live model.
REL_TOL = 1e-4
# a batch-3 artifact against the batch-1 one, element by element: the CPU's
# convolutions may block a batch of 3 otherwise than one of 1
BATCH_ATOL = 1e-5
NAMES = ('class', 'box', 'coef', 'proto')
OPS = ('window_attention', 'mlp_block', 'attn_block', 'swin_block')
MIXED = ('whole', 'attn_block', 'composed', 'composed')
# the small swin of tests/test_torch_swin.py: 72 px pads at every stage; head width 32
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))


def _ops_called(program):
    """yolact_torch:: operator calls in the program, by name, the autocast
    region's subgraphs included."""
    return Counter(str(n.target).split('.')[1]
                   for m in program.graph_module.modules() if isinstance(m, torch.fx.GraphModule)
                   for n in m.graph.nodes
                   if n.op == 'call_function' and str(n.target).startswith('yolact_torch.'))


# --- the registered operators -------------------------------------------------------

def _op_inputs(seed=0, grad=False):
    """Small CPU inputs of the four operators: C = 32, one head, 8 windows (two
    images of a 14 x 14 map padded from 12 x 12), shifted."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    c, heads = 32, 1
    region = torch.from_numpy(swin.shifted_window_regions(14, 14))
    rowmask = torch.from_numpy(swin.pad_rowmask(12, 12, 14, 14, 3))
    bias = r(heads, 49, 49, scale=0.5)
    ln = (1 + r(c, scale=0.1), r(c, scale=0.1))
    mlp = (r(4 * c, c, scale=0.1), r(4 * c, scale=0.1), r(c, 4 * c, scale=0.1), r(c, scale=0.1))
    attn = (r(3 * c, c, scale=0.1), r(3 * c, scale=0.1), bias, region, r(c, c, scale=0.1),
            r(c, scale=0.1))
    leaf = lambda t: t.requires_grad_() if grad else t
    return {
        'window_attention': (leaf(r(8, 49, 3 * c)), leaf(bias.clone()), region, heads),
        'mlp_block': tuple(leaf(t) for t in (r(98, c),) + ln + mlp),
        'attn_block': (r(8, 49, c),) + attn + (heads,),
        'swin_block': (r(8, 49, c), rowmask) + ln + attn[:2] + attn[2:] + ln + mlp + (heads,),
    }


PLAIN = {'window_attention': window_attention.window_attention_plain,
         'mlp_block': swin_mlp.mlp_block_plain, 'attn_block': attn_block.attn_block_plain,
         'swin_block': swin_block.swin_block_plain}
WRAPPERS = {'window_attention': window_attention.window_attention,
            'mlp_block': swin_mlp.mlp_block, 'attn_block': attn_block.attn_block,
            'swin_block': swin_block.swin_block}


@pytest.mark.parametrize('name', OPS)
def test_registered_op_passes_opcheck_and_equals_its_plain_version(name):
    op = getattr(torch.ops.yolact_torch, name)
    args = _op_inputs()[name]
    cases = [args]
    if name in ('window_attention', 'mlp_block'):      # kernels 3 and 4 carry a backward
        cases.append(_op_inputs(grad=True)[name])
    for case in cases:
        result = torch.library.opcheck(op, case)
        assert set(result.values()) == {'SUCCESS'}, result
    before = WRAPPERS[name].launches
    with torch.no_grad():
        ours = WRAPPERS[name](*args)
        assert torch.equal(op(*args), ours)
        assert torch.equal(ours, PLAIN[name](*args))
    assert WRAPPERS[name].launches == before                # the CPU runs the plain version


def test_registered_ops_keep_their_kernels_off_the_fake():
    """The fakes give the output's shape and dtype and allocate nothing else:
    on meta tensors no kernel runs, no scratch is made and nothing launches."""
    args = {k: tuple(t.to('meta', torch.bfloat16 if t.dtype == torch.float32 and i in (0, 4, 8, 12, 14)
                          else t.dtype) if isinstance(t, torch.Tensor) else t
                     for i, t in enumerate(v))
            for k, v in _op_inputs().items()}
    launches = [f.launches for f in WRAPPERS.values()]
    for name in OPS:
        out = getattr(torch.ops.yolact_torch, name)(*args[name])
        x = args[name][0]
        width = x.shape[-1] // 3 if name == 'window_attention' else x.shape[-1]
        assert out.device.type == 'meta' and out.dtype == x.dtype
        assert out.shape == x.shape[:-1] + (width,)
    assert [f.launches for f in WRAPPERS.values()] == launches


# --- res50 against JAX ----------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_res50():
    cfg = jax_config('res50_custom', img_size=IMG)
    init = jax.jit(lambda key: JaxYolact(cfg=cfg).init(
        key, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(4)))


@pytest.fixture(scope='module')
def res50_artifacts(jax_res50, tmp_path_factory):
    """res50_custom at 128, float32, batch 1 and batch 3, exported on the CPU
    from the bridged JAX weights; with what each export printed."""
    cfg = get_config('res50_custom', img_size=IMG)
    sd = from_jax_variables(jax_res50)
    out = tmp_path_factory.mktemp('export')
    paths, printed = {}, {}
    for batch in (1, 3):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            paths[batch] = deploy.export_model(cfg, sd, str(out / f'res50_custom_b{batch}.pt2'),
                                               check_parity=batch == 1, batch=batch,
                                               device='cpu')
        printed[batch] = buf.getvalue()
    return cfg, paths, printed


def test_res50_artifact_matches_jax(jax_res50, res50_artifacts):
    cfg, paths, printed = res50_artifacts
    assert printed[1] == 'Export parity check passed.\n' and printed[3] == ''
    img = np.random.RandomState(11).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    jm = JaxYolact(cfg=jax_config('res50_custom', img_size=IMG))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jax_res50, img)
    call, _, _ = deploy.load_exported(paths[3], device='cpu')
    for name, r, o in zip(NAMES, ref, call(img)):
        r = np.asarray(r)
        assert o.shape == r.shape and o.dtype == torch.float32, name
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err < REL_TOL, f'{name}: relative error {err}'


def test_batched_artifact_matches_per_image(res50_artifacts):
    _, paths, _ = res50_artifacts
    call1, meta1, _ = deploy.load_exported(paths[1], device='cpu')
    call3, meta3, _ = deploy.load_exported(paths[3], device='cpu')
    assert meta1['batch'] == 1 and meta3['batch'] == 3
    imgs = np.random.RandomState(12).rand(3, IMG, IMG, 3).astype(np.float32)
    outs3 = call3(imgs)
    for j in range(3):
        for name, a, b in zip(NAMES, call1(imgs[j:j + 1]), outs3):
            np.testing.assert_allclose(a[0].numpy(), b[j].numpy(), rtol=0, atol=BATCH_ATOL,
                                       err_msg=name)
    with pytest.raises(Exception):                       # the batch is fixed in the artifact
        call3(imgs[:2])


def test_meta_and_anchors_round_trip(res50_artifacts):
    cfg, paths, _ = res50_artifacts
    _, meta, anchors = deploy.load_exported(paths[3], device='cpu')
    assert meta == dict(name='res50_custom', img_size=IMG, compute_dtype='float32',
                        class_names=list(cfg.class_names), batch=3, device='cpu')
    ref = jax_make_anchors(IMG, cfg.aspect_ratios, cfg.scales)
    assert anchors.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(anchors, ref)


# --- swin ------------------------------------------------------------------------------

def test_small_swin_mixed_export_calls_all_four_ops(tmp_path):
    """The small swin in the 'mixed' forms: the saved and reloaded program
    calls each kernel's operator where the live model does and gives its
    outputs (tests/test_torch_swin.py holds the live forms to JAX)."""
    torch.manual_seed(0)
    model = swin.SwinTiny(**SMALL, block_forms=MIXED).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.from_numpy(np.random.RandomState(3).normal(size=(2, 72, 72, 3)).astype(np.float32))
    with torch.no_grad():
        live = model(x)
    program = torch.export.export(model, (x,), strict=False)
    torch.export.save(program, tmp_path / 'small.pt2')
    loaded = torch.export.load(tmp_path / 'small.pt2')
    # per stage: whole 2 calls; attn_block 2 + mlp 2; composed 2 + 2, twice
    assert _ops_called(loaded) == {'swin_block': 2, 'attn_block': 2, 'window_attention': 4,
                                   'mlp_block': 6}
    with torch.no_grad():
        outs = loaded.module()(x)
    for i, (a, b) in enumerate(zip(live, outs)):
        assert torch.equal(a, b), i
    assert model.block_forms() == MIXED


def test_bf16_swin_artifact_equals_the_live_bf16_model(tmp_path):
    """swin_tiny_coco at 64 px in bf16 and the 'mixed' forms, taken as the
    Detector holds it: the artifact equals the live model bit for bit, so the
    bf16 autocast region and the swin casts survived the export."""
    cfg = get_config('swin_tiny_coco', img_size=64, compute_dtype='bfloat16')
    det = Detector(cfg, device='cpu', seed=0)
    det.model.backbone.set_block_forms(MIXED)
    path = deploy.export_model(cfg, det.model, str(tmp_path / 'swin.pt2'), check_parity=False,
                               batch=2, device='cpu')
    call, meta, _ = deploy.load_exported(path, device='cpu')
    assert meta['block_forms'] == list(MIXED) and meta['compute_dtype'] == 'bfloat16'
    assert set(_ops_called(torch.export.load(path))) == set(OPS)
    img = np.random.RandomState(13).normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        live = det.model(torch.from_numpy(img))
    for name, a, b in zip(NAMES, live, call(img)):
        assert torch.equal(a, b), name


# --- the CLIs and the driver -----------------------------------------------------------

@pytest.fixture(scope='module')
def cli_artifact(tmp_path_factory):
    """The export CLI, `--device cpu`, on a seeded
    res50_coco .ckpt (its class-1 logit raised by 6 at every anchor, so that
    detections pass the driver's threshold) at 64 px; with its output."""
    root = tmp_path_factory.mktemp('cli')
    det = Detector(get_config('res50_coco', img_size=64), device='cpu', seed=0)
    sd = det.model.state_dict()
    sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
    weight = root / 'seeded_res50_coco.ckpt'
    save_checkpoint(str(weight), to_jax_variables(sd))
    from yolact_minimal_torch.export import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(['--weight', str(weight), '--img_size', '64', '--device', 'cpu'])
    return root, root / 'seeded_res50_coco.pt2', buf.getvalue()


def test_export_and_driver_clis_on_the_cpu(cli_artifact, monkeypatch):
    root, artifact, printed = cli_artifact
    assert 'Export parity check passed.' in printed and artifact.exists()
    images = root / 'images'
    images.mkdir()
    names = ('000001.jpg', '000002.jpg')
    shapes = {}
    for name in names:
        img = image_io.imread(ROOT / 'custom_dataset' / 'images' / name)
        shapes[name] = img.shape
        image_io.imwrite(images / name.replace('.jpg', '.png'), img)
    from yolact_minimal_torch.detect_with_export import main
    monkeypatch.chdir(root)
    main(['--artifact', str(artifact), '--image', str(images), '--device', 'cpu'])
    for name in names:
        png = name.replace('.jpg', '.png')
        out = image_io.imread(root / 'results' / 'export_images' / png)
        assert out.shape == shapes[name]
        assert not np.array_equal(out, image_io.imread(images / png))     # something was drawn


def test_driver_loads_the_artifact_without_models(cli_artifact):
    """The driver's side builds no model: loading and calling the artifact
    imports nothing of models/, JAX, flax or cv2; only the numpy tail then
    imports cv2."""
    _, artifact, _ = cli_artifact
    code = (
        'import sys\n'
        'import numpy as np\n'
        'from yolact_minimal_torch.deploy import load_exported\n'
        'from yolact_minimal_torch.ops.nms_numpy import after_nms_numpy, detect_postprocess_numpy\n'
        f'call, meta, anchors = load_exported({str(artifact)!r}, device="cpu")\n'
        'outs = [o.numpy() for o in call(np.zeros((1, 64, 64, 3), np.float32))]\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] in '
        '("jax", "jaxlib", "flax", "cv2", "yolact_minimal_tpu") or '
        'k.startswith("yolact_minimal_torch.models"))\n'
        'assert not bad, bad\n'
        'boxes, coefs, ids, scores = detect_postprocess_numpy(outs[0][0], outs[1][0], outs[2][0], '
        'anchors, 0.05, 0.5, 200, 100)\n'
        'tail = after_nms_numpy(ids, scores, boxes, coefs, outs[3][0], 48, 64)\n'
        'assert "cv2" in sys.modules and len(tail[0]) > 0 and tail[3].shape[1:] == (48, 64)\n'
        'print("ok", meta["name"], len(tail[0]))\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    proc = subprocess.run([sys.executable, '-c', code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('ok res50_coco')


def test_export_entry_points_raise_without_a_card(cli_artifact):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device is usable')
    _, artifact, _ = cli_artifact
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        deploy.load_exported(str(artifact))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        deploy.export_model(get_config('res50_coco', img_size=64), {}, 'unused.pt2')
    from yolact_minimal_torch.detect_with_export import main as driver
    from yolact_minimal_torch.export import main as export
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        export(['--weight', 'missing_res50_coco.pth'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        driver(['--artifact', str(artifact), '--image', str(ROOT)])
    with pytest.raises(ValueError, match='exported for cpu'):
        deploy.load_exported(str(artifact), device='meta')
