"""Training: SGD steps of ``repro_torch``'s CapsuleNet through its kernels.

The step is ``capsnet.train_step(backend="kernels")`` on ONE
``compile_plan(cfg, batch, train=True, pipeline=True)``, as the port's
``CapsTrainLoop`` runs it, on batches of the seeded pool: step ``k``
takes rows ``k * batch`` on, so the first steps' rows all differ.  The
cell file's ``params``: ``batch``, ``lr``, the ``pool`` size.

Set-up builds the step and its state once, drives it through its first
``CHECKED`` steps (their losses and the parameters after the first and
the last of them kept for the check) and a few more to warm up, and
hands that same state to the window.  The window runs steps back to
back and ends on a device synchronise: samples per second over all the
work and all the time of the window.

Correctness, once the window has closed: the reference follows the
first ``CHECKED`` steps from the same initial weights on the same
batches.  Compared: the first step's loss (``loss_gap``, relative); the
first step's gradient as SGD applied it, ``(p0 - p1) / lr``, all leaves
taken as one vector: the gap between the program's norm and the
reference's, over the reference's (``grad_gap``); and the parameters'
change over the ``CHECKED`` steps (``change_gap``): for each leaf the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; the median of
those over the leaves.  A leaf whose reference gradient is under a
thousandth of the median leaf's is left out of the change (round-off
alone moves it).  Norms are taken in float64.

Steady numbers, because single leaves and the later steps' losses are
not: read from fp32 parameters, ``p0 - p1`` of a leaf whose update is
a few ulps of its weights (the decoder's, scaled by the reconstruction
weight) moves with one element rounded the other way, and one ReLU unit
near zero that flips moves a small leaf's gradient (Conv1's bias by its
one term in 512 x 24 x 24) and every later loss.  The fp32 reference
reads such gaps against itself in float64.  The median leaf's gradient
gap and the worst leaf's, and the worst step's loss, are reported beside
each number (``median``, ``worst``), not compared.
"""

from __future__ import annotations

import gc
import time

import torch

from capbench import inputs, work
from capbench.reference import capsnet_ref

CHECKED = 3
WARM_STEPS = 2


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each leaf's gap of norms, over the larger of the leaf's and the
    median leaf's reference norm."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(torch.tensor(list(rn.values()), dtype=torch.float64).median())
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
            / max(rn[k], med) for k in names}


def whole_gap(prog: dict, ref: dict) -> float:
    """The gap of norms of all leaves taken as one vector, over the
    reference's."""
    def norm(t):
        return float(torch.linalg.vector_norm(torch.cat(
            [v.double().flatten() for v in t.values()])))
    rn = norm(ref)
    return abs(norm(prog) - rn) / rn


def gap_check(gaps: dict[str, float], limit: float) -> dict:
    """The median leaf's gap, compared; the worst leaf's, reported."""
    leaf = max(gaps, key=gaps.get)
    return {"value": float(torch.tensor(list(gaps.values()),
                                         dtype=torch.float64).median()),
            "limit": limit, "leaf": leaf, "worst": gaps[leaf]}


class Driver:
    def __init__(self, ctx):
        t = time.perf_counter()
        from repro_torch.core import capsnet
        from repro_torch.core.execplan import compile_plan

        self.ctx = ctx
        p = ctx.params
        self.batch, self.lr = p["batch"], p["lr"]
        if ctx.mix.get("optimizer", "sgd") != "sgd":
            raise ValueError(f"unknown optimizer {ctx.mix['optimizer']!r}")
        self.plan = compile_plan(ctx.pcfg, batch=self.batch, train=True,
                                 pipeline=True)
        self.capsnet = capsnet
        self.params = ctx.weights          # the program's state, in place
        self.k = 0
        self.losses = []
        self.snap = {}
        marks = [time.perf_counter()]
        for step in range(1, CHECKED + 1):
            self.losses.append(self._step())
            if step in (1, CHECKED):
                self.snap[step] = {k: v.detach().clone()
                                   for k, v in self.params.items()}
            marks.append(time.perf_counter())
        for _ in range(WARM_STEPS):
            self._step()
        marks.append(time.perf_counter())
        self.setup_marks = {"import and plan": marks[0] - t,
                            "first step": marks[1] - marks[0],
                            "later warm steps (unsynchronised)":
                                marks[-1] - marks[1]}
        self.steps_run = 0
        self.last_loss = None

    def _batch(self, k: int):
        n = len(self.ctx.images) // self.batch
        a = (k % n) * self.batch
        return (self.ctx.images[a:a + self.batch],
                self.ctx.labels[a:a + self.batch])

    def _step(self) -> torch.Tensor:
        x, y = self._batch(self.k)
        self.k += 1
        _, m = self.capsnet.train_step(
            self.params, x, y, self.ctx.pcfg, self.lr, backend="kernels",
            plan=self.plan, device=self.ctx.device)
        return m["loss"]

    def window(self, seconds: float, span) -> dict:
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        end = t0 + seconds
        steps = 0
        while True:
            with span("capbench.train_step"):
                self.last_loss = self._step()
            steps += 1
            if time.perf_counter() >= end:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        self.steps_run += steps
        cfg = self.ctx.cfg
        step_bound, _ = work.bound_s(work.train_flops(cfg) * self.batch,
                                     work.train_bytes(cfg, self.batch))
        return dict(wall_s=wall, steps=steps, samples=steps * self.batch,
                    flops=work.train_flops(cfg) * self.batch * steps,
                    bound_s=step_bound * steps)

    def drain(self) -> None:
        pass

    def counts(self) -> tuple[int, int]:
        ok = self.last_loss is not None and bool(
            torch.isfinite(self.last_loss))
        return self.steps_run, 0 if ok else self.steps_run

    def end_to_end(self, rec: dict) -> dict:
        return {"train_samples_per_s": rec["samples"] / rec["wall_s"]}

    def notes(self, rec: dict) -> dict:
        return {"window": f"{rec['wall_s']:.4f} s, {rec['steps']} steps of "
                          f"{self.batch}"}

    # -- correctness -------------------------------------------------------
    def check(self, precision: str = "fp32") -> dict:
        """The program's first steps against the reference's.
        ``precision="tf32"`` reads the control: the reference in TF32 in
        the program's place.  The first call frees the program's state
        before the reference runs."""
        ctx = self.ctx
        if self.params is not None:
            self.got = ([float(v) for v in self.losses], self.snap[1],
                        self.snap[CHECKED])
            self.params = self.snap = self.plan = ctx.weights = None
            gc.collect()
            if ctx.device.type == "cuda":
                torch.cuda.empty_cache()
            self.p0 = inputs.weights(ctx.cfg, ctx.seed, ctx.device)
            self.ref = follow(ctx, self.p0, "fp32", self.lr, self._batch)
        p0 = self.p0
        losses, p1, p3 = (self.got if precision == "fp32" else
                          follow(ctx, p0, precision, self.lr, self._batch))
        ref_losses, r1, r3 = self.ref
        g_prog = {k: ((p0[k] - p1[k]) / self.lr).double() for k in p0}
        g_ref = {k: ((p0[k] - r1[k]) / self.lr).double() for k in p0}
        norms = {k: float(torch.linalg.vector_norm(v))
                 for k, v in g_ref.items()}
        med = float(torch.tensor(list(norms.values()),
                                 dtype=torch.float64).median())
        moved = {k for k, n in norms.items() if n >= 1e-3 * med}
        c_prog = {k: p3[k].double() - p0[k].double() for k in p0}
        c_ref = {k: r3[k].double() - p0[k].double() for k in p0}
        lim = ctx.limits
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        grad = gap_check(leaf_gaps(g_prog, g_ref), lim["grad_gap"])
        return {
            "loss_gap": {"value": loss[0], "limit": lim["loss_gap"],
                         "worst": max(loss)},
            "grad_gap": {"value": whole_gap(g_prog, g_ref),
                         "limit": lim["grad_gap"], "median": grad["value"],
                         "leaf": grad["leaf"], "worst": grad["worst"]},
            "change_gap": gap_check(leaf_gaps(c_prog, c_ref, moved),
                                    lim["change_gap"]),
        }


def follow(ctx, p0: dict, precision: str, lr: float, batches):
    """The reference's first ``CHECKED`` SGD steps from ``p0``: their
    losses and the parameters after the first and the last."""
    p = capsnet_ref.Precision(precision)
    params, losses, snaps = p0, [], {}
    with p.context():
        for step in range(1, CHECKED + 1):
            x, y = batches(step - 1)
            params, _, loss = capsnet_ref.sgd_step(params, x, y, ctx.cfg,
                                                   lr, p)
            losses.append(loss)
            if step in (1, CHECKED):
                snaps[step] = params
    return losses, snaps[1], snaps[CHECKED]
