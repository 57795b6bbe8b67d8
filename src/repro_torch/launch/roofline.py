"""Roofline of one step on the H100: the counterpart of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds, from per-device
counts (``launch.hlo_analysis.analyze_ops``: what one rank runs):

    compute    = flops_per_device / PEAK_FLOPS
    memory     = hbm_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The collective bytes are ring-accounted, per device, from the
collectives the counters record (``collective_moved``):

    all-reduce        2 * B * (S-1)/S        (reduce-scatter + all-gather)
    all-gather        B_out * (S-1)/S        (B_out = gathered shape)
    reduce-scatter    B_out * (S-1)          (input = B_out * S)
    all-to-all        B * (S-1)/S
    collective-permute B

with S the size of the mesh dim the collective runs over.

The reference reads XLA's compiled object for its memory and cost
dictionaries; the port has none.  Its counterparts: the dry run's
per-device byte breakdown (``launch.dryrun.memory_breakdown``) and the
counters' result (``OpAnalysis``); ``hbm_bytes_estimate`` keeps the
reference's rule.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.planner import PEAK_HBM_BYTES

# NVIDIA H100 SXM (per card), NVIDIA's data sheet at the 700 W limit.
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, FLOP/s
HBM_BW = PEAK_HBM_BYTES      # 3.35e12 B/s of HBM3 (core/planner.py)
LINK_BW = 450e9              # NVLink 4: 900 GB/s a card, 450e9 B/s each way

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_moved(kind: str, nbytes: float, s: int) -> float:
    """Bytes one device moves for one collective of ``kind`` over ``s``
    participants, ring-accounted (module docstring).  ``nbytes`` is B for
    all-reduce, all-to-all and permute, and the gathered / scattered
    output B_out for all-gather / reduce-scatter, as the reference reads
    them off the op's type."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    if s <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (s - 1) / s
    if kind == "all-gather":
        return nbytes * (s - 1) / s
    if kind == "reduce-scatter":
        return nbytes * (s - 1)
    if kind == "all-to-all":
        return nbytes * (s - 1) / s
    return nbytes                                # collective-permute


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops: float           # 6*N*D (train) / 2*N*D (serve), global

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step estimate: max of the three terms (full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops (catches remat/redundancy waste)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step estimate."""
        denom = self.step_time_s * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D per generated/scored token."""
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * d_tokens


def hbm_bytes_estimate(counted_bytes: float | None, memory: dict) -> float:
    """The reference's rule: prefer the counted bytes (the counters'
    ``memory_bytes``); else every argument + output + 2x the activations
    (``memory``: the dry run's breakdown)."""
    if counted_bytes is not None:
        return counted_bytes
    return (memory.get("argument_bytes", 0) + memory.get("output_bytes", 0)
            + 2.0 * memory.get("activation_bytes", 0))
