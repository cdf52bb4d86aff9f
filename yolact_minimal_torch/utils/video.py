"""Batched video detection, shared by the detect CLI and the exported-artifact
driver.

Frames go through the device a batch at a time. A reader thread decodes the
next batch and runs `val_aug` on it while the device works on this one; a
writer thread draws and encodes the previous batch. The last batch is padded
with its last frame to the full batch. With `real_time` the frames are shown
with cv2.imshow on the calling thread instead (several GUI back ends hang or
crash off the main thread). Needs cv2, imported at first use.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np

from yolact_minimal_torch.data import augment
from yolact_minimal_torch.utils.progress import ProgressBar

NO_CV2 = 'video input needs cv2: frames are decoded and encoded with cv2.VideoCapture / VideoWriter'


def import_cv2():
    """cv2, or an ImportError that says what video needs it for."""
    return augment.import_cv2(NO_CV2)


def run_video(path: str, out_dir: Optional[str], batch: int, img_size: int,
              detect: Callable[[np.ndarray], object],
              draw: Callable[[object, int, np.ndarray, float], np.ndarray]
              ) -> Tuple[int, float]:
    """Detect every frame of the video at `path`. `detect(images [batch,
    img_size, img_size, 3] float32)` runs on the calling thread and returns
    what `draw(result, j, frame, fps)` needs to draw frame j of the batch;
    draw returns the drawn frame. The frames are written to
    `out_dir/<basename of path>` (mp4v, the input's frame rate rounded to
    an integer, as the JAX package writes it, and its size), or
    with `out_dir` None shown in a window. Returns (frames, frames a second
    after the first batch, which includes the warm-up)."""
    cv2 = import_cv2()
    vid = cv2.VideoCapture(path)
    if not vid.isOpened():
        raise ValueError(f'cannot open the video {path}')
    size = (round(vid.get(cv2.CAP_PROP_FRAME_WIDTH)), round(vid.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    total = round(vid.get(cv2.CAP_PROP_FRAME_COUNT))
    writer = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        writer = cv2.VideoWriter(os.path.join(out_dir, os.path.basename(path)),
                                 cv2.VideoWriter_fourcc(*'mp4v'),
                                 round(vid.get(cv2.CAP_PROP_FPS)), size)
    progress = ProgressBar(40, total)
    reader, drawer = ThreadPoolExecutor(1), ThreadPoolExecutor(1)

    def read_batch():
        frames = []
        while len(frames) < batch:
            ok, frame = vid.read()
            if not ok:
                break
            frames.append(frame)
        return frames, [augment.val_aug(f, img_size) for f in frames]

    def finish(frames, result, fps):
        outs = [draw(result, j, frame, fps) for j, frame in enumerate(frames)]
        if writer is not None:
            for out in outs:
                writer.write(out)
        return outs

    done, fps, t0, warm = 0, 0.0, None, 0
    pending = None
    fut = reader.submit(read_batch)
    try:
        while True:
            frames, normed = fut.result()
            if not frames:
                break
            fut = reader.submit(read_batch)
            images = np.stack(normed)
            if len(frames) < batch:
                images = np.concatenate([images, np.repeat(images[-1:], batch - len(frames), 0)])
            result = detect(images)
            if pending is not None:
                pending.result()
            if writer is None:
                for out in finish(frames, result, fps):
                    cv2.imshow('Detection', out)
                    cv2.waitKey(1)
            else:
                pending = drawer.submit(finish, frames, result, fps)
            done += len(frames)
            if t0 is None:
                t0, warm = time.perf_counter(), done
            else:
                fps = (done - warm) / (time.perf_counter() - t0)
            print(f'\rDetecting: {progress.get_bar(done)} {done}/{total}, fps: {fps:.2f}', end='')
        if pending is not None:
            pending.result()
    finally:
        # the reader may still be in vid.read(): drain it before the release
        reader.shutdown(wait=True)
        drawer.shutdown(wait=True)
        vid.release()
        if writer is not None:
            writer.release()
    print()
    return done, fps
