"""Faults planted underneath the timed path, to show that the check sees
them: each is a context manager that patches ``repro_torch`` while it is
open.  The benchmark's own runs plant none; the tests and
``calibrate.py --fault`` do.

- ``altered_answer``: every served answer altered where it is produced
  (the forward's lengths scaled by 1.001);
- ``unchanged_state``: a training step that computes its gradient and
  returns its state unchanged;
- ``half_batch``: a training step that leaves half of the batch out and
  takes the mean over the rest (the first half's rows twice).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    orig = getattr(module, name)
    setattr(module, name, replacement(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def altered_answer():
    from repro_torch.core import capsnet

    def wrap(orig):
        def forward(*args, **kw):
            out = orig(*args, **kw)
            out["lengths"] = out["lengths"] * 1.001
            return out
        return forward
    return _patched(capsnet, "forward", wrap)


def unchanged_state():
    from repro_torch.core import capsnet

    def wrap(orig):
        def train_step(params, images, labels, cfg, lr=1e-3, **kw):
            _, metrics = capsnet.loss_and_grads(params, images, labels, cfg,
                                                **kw)
            return params, metrics
        return train_step
    return _patched(capsnet, "train_step", wrap)


def half_batch():
    from repro_torch.core import capsnet

    def wrap(orig):
        def train_step(params, images, labels, *args, **kw):
            h = images.shape[0] // 2
            return orig(params, torch.cat([images[:h], images[:h]]),
                        torch.cat([labels[:h], labels[:h]]), *args, **kw)
        return train_step
    return _patched(capsnet, "train_step", wrap)


FAULTS = {"altered_answer": altered_answer,
          "unchanged_state": unchanged_state,
          "half_batch": half_batch}
