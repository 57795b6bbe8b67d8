"""Deterministic synthetic MNIST-like batches: the counterpart of
``repro/train/data.py``'s ``DataConfig`` and ``mnist_batch``.

Every batch is a pure function of ``(seed, step, host)``, so a restored
run at step S regenerates exactly the batches S, S+1, ... with no state
beyond the step.  The digits are class-dependent Gaussian blobs plus
noise, so losses fall in a few steps; nothing is downloaded.  The port
draws its labels and noise from numpy's generator, not JAX's, so its
batches differ from the reference's; parity tests feed both the same
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's ``DataConfig`` for its ``"mnist"`` kind, the only
    one the port generates."""

    global_batch: int = 8
    seed: int = 0


def blobs(labels: np.ndarray, noise: np.ndarray,
          channels: int = 1) -> np.ndarray:
    """The reference's digit images from ``labels [B]`` and ``noise
    [B, H, W]`` (uniform in [0, 1)): a blob whose place and width depend
    on the class, plus 0.08 of the noise, clipped to [0, 1]; with
    ``channels > 1`` each channel is tinted by the class."""
    hw = noise.shape[1]
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    cy = 6 + 2 * (labels % 5)
    cx = 6 + 4 * (labels // 5)
    sigma = 2.0 + 0.35 * labels
    blob = np.exp(-(((yy[None] - cy[:, None, None]) ** 2
                     + (xx[None] - cx[:, None, None]) ** 2)
                    / (2 * sigma[:, None, None] ** 2)))
    img = np.clip(blob + 0.08 * noise, 0.0, 1.0)[..., None]
    if channels > 1:
        tint = 0.5 + 0.5 * np.cos(labels[:, None]
                                  * (1.0 + np.arange(channels)))
        img = img * tint[:, None, None, :]
    return img.astype(np.float32)


def mnist_batch(cfg: DataConfig, step: int, host: int = 0,
                num_hosts: int = 1, image_hw: int = 28,
                channels: int = 1) -> dict[str, np.ndarray]:
    """``{"images": [B, H, W, C] float32, "labels": [B] int64}`` for one
    step, B = ``global_batch // num_hosts``."""
    b = cfg.global_batch // num_hosts
    rng = np.random.default_rng((cfg.seed, step, host))
    labels = rng.integers(0, 10, size=b)
    noise = rng.random((b, image_hw, image_hw))
    return {"images": blobs(labels, noise, channels),
            "labels": labels.astype(np.int64)}
