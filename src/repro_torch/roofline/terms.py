"""Roofline terms from a dry run's cost and memory analysis — the port of
``repro/roofline/terms.py``, with the NVIDIA H100 SXM's terms as the
default (``HW_H100``, the same keys as the reference's hardware dict).

From NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit:

    peak bf16 tensor-core compute   989 TFLOP/s
    HBM3 bandwidth                  3.35 TB/s
    NVLink 4                        450 GB/s each way, all to all
                                    through the NVSwitch of one HGX host
    HBM capacity                    80 GB

A mesh axis that crosses HGX hosts runs over the hosts' NICs instead:
400 Gb/s, 50 GB/s a GPU.  ``link_bw`` is NVLink's, so on such an axis the
collective term is a lower bound.  A float32 program without TF32 (the
port keeps TF32 off, as the reference keeps ``Precision.HIGHEST``) runs
outside the tensor cores, at ``H100_F32_FLOPS`` = 67 TFLOP/s: pass
``hw=dict(HW_H100, peak_flops=H100_F32_FLOPS)``.  A card set below 700 W
runs slower under load.

All inputs are PER-DEVICE quantities (a recorded sharded call counts one
rank's share, ``analysis/tracekit.py``), so:

    compute    = flops / peak
    memory     = hbm_bytes / hbm_bw
    collective = collective_bytes / link_bw

dominant bottleneck = argmax; the bound is the largest term, the least
time the card could take for the recorded work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

HW_H100 = dict(
    name="h100_sxm",
    peak_flops=989e12,          # bf16 dense tensor-core FLOP/s per GPU
    hbm_bw=3.35e12,             # bytes/s per GPU
    link_bw=450e9,              # NVLink 4 bytes/s per GPU, each way
    hbm_bytes=80e9,             # capacity, for fit checks
)
H100_F32_FLOPS = 67e12          # float32 FLOP/s outside the tensor cores


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict[str, float]:
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, dominant=self.dominant)


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   collective_bytes_per_device: float,
                   hw: dict = HW_H100) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / hw["peak_flops"],
        memory_s=hbm_bytes_per_device / hw["hbm_bw"],
        collective_s=collective_bytes_per_device / hw["link_bw"])


def model_flops_lm(n_params: int, n_active_params: int, tokens: int,
                   train: bool) -> float:
    """6·N_active·D for train, 2·N_active·D for inference forward."""
    mult = 6.0 if train else 2.0
    return mult * n_active_params * tokens


def useful_fraction(model_flops: float, hlo_flops_global: float) -> float:
    """MODEL_FLOPS / recorded FLOPs — how much of the recorded compute is
    'useful' (catches remat recompute, padding and routing waste)."""
    return model_flops / max(hlo_flops_global, 1.0)
