"""Video input on the CPU: an 11-frame seeded mp4 (not a multiple of the
batch, so the last batch is padded) through the detect CLI (`--video
--video_bs 4`) and through the exported-artifact driver (`--video`, an
artifact of batch 4). Each writes 11 frames at the input size, and each
frame's slate equals that frame detected alone by `detect.detect_one`: the
same ids, scores within 1e-5 (the driver's numpy tail and the device
postprocess decode and sort with other libraries, in float32). The JAX
package's video test is slow; this one holds the port to its own
single-image path, which the other tests hold to JAX. The written file's
frame rate is the input's rounded, as the JAX loops write it, and the
exported-artifact CLI writes its file under `--real_time` too."""
import contextlib
import io

import cv2
import numpy as np
import pytest
import torch

from yolact_minimal_torch import detect, detect_with_export
from yolact_minimal_torch.config import get_config
from yolact_minimal_torch.data.augment import val_aug
from yolact_minimal_torch.pipeline import Detector, load_detector
from yolact_minimal_torch.utils import video, visualize
from yolact_minimal_torch.utils.checkpoint import save_checkpoint
from yolact_minimal_torch.utils.weights import to_jax_variables

torch.set_num_threads(1)

IMG = 64
N_FRAMES = 11
BATCH = 4
SIZE = (96, 80)                     # width, height
SCORE_TOL = 1e-5


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    """The mp4, a seeded res50_coco .ckpt whose class-1 logit is raised by 6
    at every anchor (detections pass the 0.3 threshold), its batch-4 artifact
    from the export CLI, and each frame's slate from detect_one."""
    root = tmp_path_factory.mktemp('video')
    rng = np.random.RandomState(0)
    writer = cv2.VideoWriter(str(root / 'in.mp4'), cv2.VideoWriter_fourcc(*'mp4v'), 10, SIZE)
    for _ in range(N_FRAMES):
        writer.write((rng.rand(SIZE[1], SIZE[0], 3) * 255).astype(np.uint8))
    writer.release()
    det = Detector(get_config('res50_coco', img_size=IMG), device='cpu', seed=0)
    sd = det.model.state_dict()
    sd['prediction_layers.conf_layer.bias'][1::81] += 6.0
    weight = root / 'seeded_res50_coco.ckpt'
    save_checkpoint(str(weight), to_jax_variables(sd))
    from yolact_minimal_torch.export import main as export
    with contextlib.redirect_stdout(io.StringIO()):
        export(['--weight', str(weight), '--img_size', str(IMG), '--batch', str(BATCH),
                '--device', 'cpu'])

    cfg = get_config('res50_coco', mode='detect', img_size=IMG)
    detector = load_detector(str(weight), cfg, device='cpu')
    vid = cv2.VideoCapture(str(root / 'in.mp4'))
    alone = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detect, 'draw_img', _recording(alone))
        while True:
            ok, frame = vid.read()
            if not ok:
                break
            detect.detect_one(detector, cfg, val_aug(frame, IMG), frame)
    vid.release()
    assert len(alone) == N_FRAMES and all(len(ids) for ids, _ in alone)
    return root, weight, root / 'seeded_res50_coco.pt2', alone


def _recording(slates):
    """draw_img that first records each frame's (ids, scores)."""
    def draw(ids, scores, boxes, masks, img_origin, cfg, **kw):
        slates.append((np.asarray(ids).copy(), np.asarray(scores).copy()))
        return visualize.draw_img(ids, scores, boxes, masks, img_origin, cfg, **kw)
    return draw


def _hold(path, slates, alone):
    out = cv2.VideoCapture(str(path))
    assert round(out.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES
    assert (round(out.get(cv2.CAP_PROP_FRAME_WIDTH)),
            round(out.get(cv2.CAP_PROP_FRAME_HEIGHT))) == SIZE
    out.release()
    assert len(slates) == N_FRAMES
    for i, ((ids, scores), (ref_ids, ref_scores)) in enumerate(zip(slates, alone)):
        np.testing.assert_array_equal(ids, ref_ids, err_msg=f'frame {i}')
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=SCORE_TOL,
                                   err_msg=f'frame {i}')


def test_detect_cli_video(clip, monkeypatch):
    root, weight, _, alone = clip
    slates = []
    monkeypatch.setattr(detect, 'draw_img', _recording(slates))
    monkeypatch.chdir(root)
    detect.main(['--weight', str(weight), '--video', str(root / 'in.mp4'), '--video_bs',
                 str(BATCH), '--img_size', str(IMG), '--device', 'cpu'])
    _hold(root / 'results' / 'videos' / 'in.mp4', slates, alone)


def test_export_driver_video(clip, monkeypatch):
    root, _, artifact, alone = clip
    slates = []
    monkeypatch.setattr(detect_with_export, 'draw_img', _recording(slates))
    monkeypatch.chdir(root)
    detect_with_export.main(['--artifact', str(artifact), '--video', str(root / 'in.mp4'),
                             '--device', 'cpu'])
    _hold(root / 'results' / 'export_videos' / 'in.mp4', slates, alone)


def test_video_needs_cv2_before_the_detector_is_built(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'cv2', None)
    with pytest.raises(SystemExit, match='video input needs cv2'):
        detect.main(['--weight', 'missing_res50_coco.pth', '--video', str(tmp_path / 'in.mp4'),
                     '--device', 'cpu'])
    with pytest.raises(SystemExit, match='video input needs cv2'):
        detect_with_export.main(['--artifact', 'missing.pt2', '--video', 'in.mp4',
                                 '--device', 'cpu'])


def test_video_writer_rounds_the_frame_rate(tmp_path):
    """A clip written by cv2 at 29.97 fps: the JAX loops hand
    round(CAP_PROP_FPS) to the writer, and so does run_video."""
    rng = np.random.RandomState(1)
    src = str(tmp_path / 'ntsc.mp4')
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*'mp4v'), 29.97, SIZE)
    for _ in range(3):
        writer.write((rng.rand(SIZE[1], SIZE[0], 3) * 255).astype(np.uint8))
    writer.release()
    vid = cv2.VideoCapture(src)
    rate = vid.get(cv2.CAP_PROP_FPS)
    vid.release()
    assert rate != round(rate)                  # the input's rate is not an integer
    frames, _ = video.run_video(src, str(tmp_path / 'out'), 2, IMG, lambda images: None,
                                lambda result, j, frame, fps: frame)
    out = cv2.VideoCapture(str(tmp_path / 'out' / 'ntsc.mp4'))
    assert frames == 3 and out.get(cv2.CAP_PROP_FPS) == round(rate) == 30
    out.release()


def test_export_video_real_time_writes_its_file(clip, monkeypatch):
    """--real_time draws the frame rate on each frame and still writes
    results/export_videos/<name>, as the JAX detect_with_export.py does (no
    window)."""
    root, _, artifact, alone = clip
    sub = root / 'real_time'
    sub.mkdir()
    monkeypatch.chdir(sub)
    monkeypatch.setattr(cv2, 'imshow', None)    # a window would fail on a machine without one
    detect_with_export.main(['--artifact', str(artifact), '--video', str(root / 'in.mp4'),
                             '--real_time', '--device', 'cpu'])
    out = cv2.VideoCapture(str(sub / 'results' / 'export_videos' / 'in.mp4'))
    assert round(out.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES
    out.release()
