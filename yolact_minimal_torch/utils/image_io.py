"""Image files in and out, as cv2 gives them: BGR uint8 arrays [H, W, 3].

`imread` and `imwrite` use cv2 where it imports, else PIL. With neither,
`backend()` raises at once with an error that names both. Nothing is imported
until first use, so importing this module needs neither library.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

NO_LIBRARY = 'neither cv2 nor PIL imports: images are read and written through one of them'


@lru_cache(maxsize=None)
def backend() -> str:
    """'cv2' or 'PIL', whichever reads, writes and labels the images.
    Raises ImportError when neither imports."""
    try:
        import cv2  # noqa: F401
        return 'cv2'
    except ImportError:
        pass
    try:
        from PIL import Image  # noqa: F401
        return 'PIL'
    except ImportError:
        raise ImportError(NO_LIBRARY) from None


def imread(path) -> np.ndarray:
    """The image at `path` as BGR uint8 [H, W, 3] (grey is repeated, alpha
    dropped, as cv2.imread does). Raises when the file cannot be read."""
    path = str(path)
    if backend() == 'cv2':
        import cv2
        img = cv2.imread(path)
    else:
        from PIL import Image, ImageOps
        try:
            with Image.open(path) as im:
                img = np.asarray(ImageOps.exif_transpose(im).convert('RGB'))[:, :, ::-1]
        except OSError:
            img = None
    if img is None:
        raise ValueError(f'cannot read the image {path}')
    return np.ascontiguousarray(img)


def imwrite(path, img: np.ndarray) -> None:
    """Write BGR uint8 [H, W, 3] to `path`; the suffix picks the format."""
    path = str(path)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if backend() == 'cv2':
        import cv2
        if not cv2.imwrite(path, img):
            raise ValueError(f'cv2 cannot write {path}')
    else:
        from PIL import Image
        # 95 is cv2's JPEG quality; PIL ignores it for other formats
        Image.fromarray(img[:, :, ::-1]).save(path, quality=95)
