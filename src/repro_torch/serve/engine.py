"""Batched LM serving engine: slot-based continuous batching, the
counterpart of ``repro/serve/engine.py``'s ``ServeEngine``.

A fixed number of batch slots share one batched KV cache on the device.
A new request prefills straight into its slot of that cache (a forward on
views of the slot's row, so no single-request cache is made and spliced
in as the reference's ``_merge_cache_slot`` does); every tick decodes one
token for ALL slots with per-slot cache positions (``cache_index`` is a
vector, K15's per-row ``kv_len`` on ``backend="kernels"``).  Finished
slots (EOS / max tokens / a full cache) free at once and are refilled from
the queue.  Admission, the ``_maybe_finish`` rule and the tick are the
reference's, so tokens and finish order equal the reference engine's.

A refilled slot keeps the earlier request's K/V past the new prompt; no
key past a row's length is ever weighed (each row sees ``kv_len`` keys),
so stale entries never reach a result.  Runs under ``torch.no_grad()``.

The decode tick works on fixed buffers the engine owns: the slots' last
tokens ``[slots, 1]`` and lengths ``[slots]`` (int64, copied in from the
host before each tick), the last position's logits and their argmax.
On the card the tick is one CUDA graph, the counterpart of the
reference's jitted decode step: the first tick runs eagerly (it loads the
kernels and fills the plan caches), the second captures the forward into
a ``torch.cuda.CUDAGraph`` and replays it, and every later tick replays
it.  The graph reads the engine's params and KV cache in place, so a
prefill (eager: its length varies) writes into the storage the graph
reads.  The kernel wrappers count their launches on the host, so the
launch counters (``build.Kernel.launches``, K15's ``SCHEDULE_LAUNCHES``)
see the eager ticks and the capture, never a replay; ``graph_replays``
counts the replays.  While a fault is injected
(``core/faults.py``) a tick runs eagerly, so the kernel wrappers' fault
sites fire; ``cuda_graph=False`` makes every tick eager.  On the CPU
every tick runs eagerly on the same buffers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BACKENDS
from repro_torch.models.transformer import (cache_slot, forward,
                                            init_model_cache)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [T] int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = dataclasses.field(default_factory=list)
    prefill_logits: np.ndarray | None = None


class ServeEngine:
    """Continuous-batching greedy (or ``sampler``) LM server.

    ``sampler`` maps the slots' last logits (numpy ``[slots, V]``) to
    tokens, as the reference's does; without one the engine takes the
    argmax on the device and copies only the tokens back.  ``timings``
    holds each prefill's and each decode tick's host seconds (each ends
    in a copy to the host, which waits for the device), ``tick_kinds``
    how many ticks ran each way: ``"eager"``, ``"capture"`` (the capture
    and its first replay) or ``"replay"``, and ``last_tick`` how the
    latest one ran.  ``cuda_graph``
    (default on) runs the tick as a CUDA graph on the card; the CPU has
    none."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, cache_dtype: torch.dtype = torch.float32,
                 sampler: Callable | None = None, backend: str = "kernels",
                 device: str | torch.device = "cuda",
                 cuda_graph: bool = True):
        if not cfg.has_decode:
            raise ValueError("encoder-only model has no decode path")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.backend = backend
        self.cache = init_model_cache(cfg, slots, max_len, cache_dtype,
                                      device=self.device)
        self.cache_dtype = cache_dtype
        self.active: list[Request | None] = [None] * slots
        self.lengths = np.zeros(slots, np.int32)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.sampler = sampler
        self.ticks = 0
        self.timings: dict[str, list[float]] = {"prefill_s": [],
                                                "decode_s": []}
        self.tick_kinds: Counter[str] = Counter()
        self.last_tick = ""
        # The tick's fixed buffers, and host staging for the inputs
        # (pinned on the card, so their copies are asynchronous).
        on_card = self.device.type == "cuda"
        self._host_tokens = torch.zeros((slots, 1), dtype=torch.long,
                                        pin_memory=on_card)
        self._host_lengths = torch.zeros(slots, dtype=torch.long,
                                         pin_memory=on_card)
        self._tokens = torch.zeros((slots, 1), dtype=torch.long,
                                   device=self.device)
        self._lengths = torch.zeros(slots, dtype=torch.long,
                                    device=self.device)
        self._logits = torch.zeros((slots, cfg.padded_vocab_size),
                                   dtype=torch.float32, device=self.device)
        self._argmax = torch.zeros(slots, dtype=torch.long,
                                   device=self.device)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._replays = 0
        self._warm = False

    @property
    def graph_replays(self) -> int:
        """Replays of the tick's CUDA graph so far (the capture's included)."""
        return self._replays

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """logits [n, V] on the device -> n tokens on the host."""
        if self.sampler is None:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        return np.asarray(self.sampler(logits.float().cpu().numpy()))

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not 1 <= len(req.prompt) <= self.max_len:
            raise ValueError(f"request {req.rid}: prompt of "
                             f"{len(req.prompt)} tokens; the cache holds "
                             f"1..{self.max_len}")
        self.queue.append(req)

    @torch.no_grad()
    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                t0 = time.perf_counter()
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                         device=self.device)[None]
                logits, _, _ = forward(
                    self.params, tokens, cfg=self.cfg,
                    cache=cache_slot(self.cache, s), cache_index=0,
                    backend=self.backend, last_only=True)
                last = logits[:, -1]
                req.output.append(int(self._sample(last)[0]))
                req.prefill_logits = last[0].float().cpu().numpy()
                self.timings["prefill_s"].append(time.perf_counter() - t0)
                self.active[s] = req
                self.lengths[s] = len(req.prompt)
                self._maybe_finish(s)

    def _maybe_finish(self, s: int) -> None:
        req = self.active[s]
        if req is None:
            return
        last = req.output[-1] if req.output else None
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and last == req.eos_id)
                or self.lengths[s] + 1 >= self.max_len):
            self.finished.append(req)
            self.active[s] = None
            self.lengths[s] = 0

    # -- the decode tick ----------------------------------------------------
    def _tick(self) -> None:
        """Decode every slot's last token at its length into the fixed
        buffers: the last position's logits and their argmax."""
        logits, _, _ = forward(self.params, self._tokens, cfg=self.cfg,
                               cache=self.cache, cache_index=self._lengths,
                               backend=self.backend)
        self._logits.copy_(logits[:, -1])
        torch.argmax(self._logits, dim=-1, out=self._argmax)

    def _run_tick(self) -> str:
        """Run the tick: eagerly (the CPU, the first tick on the card, a
        tick under fault injection, ``cuda_graph=False``), or by capturing
        the CUDA graph once and replaying it.  Returns how it ran."""
        if not self.cuda_graph or faults.enabled() or not self._warm:
            if self._stream is None:
                self._tick()
            else:             # on the stream the capture will use
                self._stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self._stream):
                    self._tick()
                torch.cuda.current_stream().wait_stream(self._stream)
                self._warm = True
            return "eager"
        kind = "replay"
        if self._graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                self._tick()
            self._graph = graph
            kind = "capture"
        self._graph.replay()
        self._replays += 1
        return kind

    # -- main loop ---------------------------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: admit + decode all slots.  Returns the number
        of active requests that advanced."""
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        t0 = time.perf_counter()
        self._host_tokens.zero_()
        for s in act:
            self._host_tokens[s, 0] = self.active[s].output[-1]
        self._host_lengths.copy_(torch.from_numpy(self.lengths))
        self._tokens.copy_(self._host_tokens, non_blocking=True)
        self._lengths.copy_(self._host_lengths, non_blocking=True)
        self.last_tick = self._run_tick()
        self.tick_kinds[self.last_tick] += 1
        if self.sampler is None:
            toks = self._argmax.cpu().numpy()
        else:
            toks = np.asarray(self.sampler(self._logits.cpu().numpy()))
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for s in act:
            self.lengths[s] += 1
            self.active[s].output.append(int(toks[s]))
            self._maybe_finish(s)
        self.ticks += 1
        return len(act)

    def run(self) -> list[Request]:
        while self.queue or any(a is not None for a in self.active):
            self.step()
        return self.finished

