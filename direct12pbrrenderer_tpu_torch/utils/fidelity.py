"""Image-fidelity metrics and the golden-frame check — the port's copy of the
JAX package's `utils/fidelity.py` (same arithmetic), without its golden
writer.

`rmse` is the frame metric of the fidelity bars (uint8 frames are taken over
255); `compare_to_golden` holds a frame to a PNG golden under `tests/goldens/`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Per-pixel RMSE over [0,1]-normalized RGB."""
    x = np.asarray(a, np.float32)
    y = np.asarray(b, np.float32)
    if x.dtype != np.float32 or x.max() > 1.5:
        x = x / 255.0
    if y.max() > 1.5:
        y = y / 255.0
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    return float(np.sqrt(np.mean((x.astype(np.float64) - y.astype(np.float64)) ** 2)))


def compare_to_golden(img: np.ndarray, golden_path: str | Path, tol: float) -> float:
    """Returns the RMSE vs the stored golden (a missing golden raises: the
    port never writes one). Raises AssertionError past tolerance."""
    from PIL import Image

    golden = np.asarray(Image.open(golden_path))
    err = rmse(np.asarray(img), golden)
    if err > tol:
        raise AssertionError(f"golden mismatch: rmse {err:.6f} > {tol} vs {golden_path}")
    return err
