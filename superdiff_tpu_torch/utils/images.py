"""Image grid utilities (the port's copy of ``superdiff_tpu/utils/images.py``;
``cifar/train_utils.py:54-62``, ``clip_eval.py:46-60``)."""

from __future__ import annotations

import numpy as np


def stack_imgs(x: np.ndarray, n: int = 8, m: int = 8) -> np.ndarray:
    """Tile the first n*m images (float [0,1] or uint8) into one uint8 grid."""
    x = np.asarray(x)
    size = x.shape[1]
    c = x.shape[-1]
    grid = np.zeros((n * size, m * size, c), dtype=np.uint8)
    for i in range(n):
        for j in range(m):
            img = x[i * m + j]
            if img.dtype != np.uint8:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            grid[i * size : (i + 1) * size, j * size : (j + 1) * size] = img
    return grid
