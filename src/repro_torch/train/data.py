"""Deterministic synthetic data: the counterpart of
``repro/train/data.py`` (``DataConfig``, the LM token stream, audio
frames, MNIST-like digits, ``batch_for_step``, ``DataIterator``).

Every batch is a pure function of ``(seed, step, host)``, so a restored
run at step S regenerates exactly the batches S, S+1, ... with no state
beyond the step (``DataIterator.skip_to`` is O(1)).  The token stream has
learnable structure (``x[t+1] = x[t] + a mod V`` with 5% noise) and the
digits are class-dependent Gaussian blobs plus noise, so losses fall in a
few steps; nothing is downloaded.  The port draws from numpy's
generator keyed by ``(seed, step, host)``, not JAX's, so its batches
differ from the reference's; parity tests feed both the same arrays.
Batches are numpy arrays; the training loops move them to their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's ``DataConfig``; ``kind`` is ``"lm"``, ``"frames"``
    or ``"mnist"`` (the default, so ``DataConfig(global_batch=...)``
    makes digits)."""

    kind: str = "mnist"
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    frontend_dim: int = 512
    seed: int = 0


def _rng(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng((cfg.seed, step, host))


def lm_batch(cfg: DataConfig, step: int, host: int = 0,
             num_hosts: int = 1) -> dict[str, np.ndarray]:
    """``{"inputs", "targets"}``, int64 ``[B, seq_len]``, B =
    ``global_batch // num_hosts``: each row ``(x0 + a t) mod V`` for a
    random start x0 and stride a in 31..45 (odd), 5% of the tokens
    replaced by ``(7 x + 3) mod V``; targets are inputs shifted by one."""
    b = cfg.global_batch // num_hosts
    rng = _rng(cfg, step, host)
    x0 = rng.integers(0, cfg.vocab_size, (b, 1))
    mult = 31 + 2 * rng.integers(0, 8, (b, 1))
    noise = rng.random((b, cfg.seq_len + 1)) < 0.05
    seq = (x0 + mult * np.arange(cfg.seq_len + 1)[None, :]) % cfg.vocab_size
    seq = np.where(noise, (seq * 7 + 3) % cfg.vocab_size, seq)
    return {"inputs": seq[:, :-1].astype(np.int64),
            "targets": seq[:, 1:].astype(np.int64)}


def frames_batch(cfg: DataConfig, step: int, host: int = 0,
                 num_hosts: int = 1) -> dict[str, np.ndarray]:
    """Audio-frontend stub: ``{"inputs": [B, T, F] float32 frames,
    "targets": [B, T] int64 cluster ids}``, each frame its cluster's
    centre (fixed by the seed) plus 0.3 of Gaussian noise."""
    b = cfg.global_batch // num_hosts
    rng = _rng(cfg, step, host)
    centers = np.random.default_rng((cfg.seed + 1,)).standard_normal(
        (cfg.vocab_size, cfg.frontend_dim), dtype=np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, cfg.seq_len))
    frames = centers[labels] + 0.3 * rng.standard_normal(
        (b, cfg.seq_len, cfg.frontend_dim), dtype=np.float32)
    return {"inputs": frames.astype(np.float32),
            "targets": labels.astype(np.int64)}


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
    rng = _rng(cfg, step, host)
    labels = rng.integers(0, 10, size=b)
    noise = rng.random((b, image_hw, image_hw))
    return {"images": blobs(labels, noise, channels),
            "labels": labels.astype(np.int64)}


def batch_for_step(cfg: DataConfig, step: int, host: int = 0,
                   num_hosts: int = 1) -> dict[str, np.ndarray]:
    if cfg.kind == "lm":
        return lm_batch(cfg, step, host, num_hosts)
    if cfg.kind == "frames":
        return frames_batch(cfg, step, host, num_hosts)
    if cfg.kind == "mnist":
        return mnist_batch(cfg, step, host, num_hosts)
    raise ValueError(cfg.kind)


class DataIterator:
    """The batches of steps ``start_step``, ``start_step + 1``, ...;
    ``skip_to`` jumps in O(1)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, host: int = 0,
                 num_hosts: int = 1):
        self.cfg, self.step, self.host, self.num_hosts = (
            cfg, start_step, host, num_hosts)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = batch_for_step(self.cfg, self.step, self.host,
                               self.num_hosts)
        self.step += 1
        return batch

    def skip_to(self, step: int) -> None:
        self.step = step
