"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity
dispatch — the port of ``repro/models/moe.py``.

Dispatch is the sort-free capacity-slot scheme: each (token, choice) pair
claims a slot in its expert's capacity buffer through a cumulative count
over the one-hot routing matrix, in the order of the flattened (token, k)
pairs; the expert FFNs run as batched GEMMs over [E, C, D], and the
results are gathered back with the combine weights.  Pairs past an
expert's capacity go to a dump slot ``C`` that is sliced off; on the way
back they gather slot ``C - 1`` times a weight of 0, so a dropped token
falls through the residual (GShard).

Routing matches ``lax.top_k``: the router's product is rounded to the
model dtype before its float32 upcast, and equal probabilities rank the
lower expert id first (a stable descending sort).  Every index is built
on the device (no ``nonzero``, no boolean-mask indexing), so the host
waits for nothing.

Aux losses: load-balance (Switch) + router z-loss.  The reference's
``shard`` argument ("ep" or "tp") only places buffers on a mesh; the port
runs on one device and accepts it unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models import common
from repro_torch.models.common import swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    balance_coef: float = 0.01
    z_coef: float = 1e-3


def moe_spec(cfg: MoEConfig) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    spec = dict(
        router=("dense", d, e),
        w_gate=("normal", (e, d, f), 1.0 / math.sqrt(d)),
        w_up=("normal", (e, d, f), 1.0 / math.sqrt(d)),
        w_down=("normal", (e, f, d), 1.0 / math.sqrt(f)))
    if cfg.n_shared:
        fs = f * cfg.n_shared
        spec["shared_gate"] = ("dense", d, fs)
        spec["shared_up"] = ("dense", d, fs)
        spec["shared_down"] = ("dense", fs, d)
    return spec


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    return common.materialize(moe_spec(cfg), gen, dtype)


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


class Routing(NamedTuple):
    """One routing decision over T tokens (K choices, E experts, C slots)."""
    logits: torch.Tensor      # [T, E] f32
    probs: torch.Tensor       # [T, E] f32
    gate_vals: torch.Tensor   # [T, K] f32, renormalised
    gate_idx: torch.Tensor    # [T, K] int64 expert ids
    slot_of: torch.Tensor     # [T*K] slot claimed by each (token, k) pair
    keep: torch.Tensor        # [T*K] bool, slot_of < C
    slot_token: torch.Tensor  # [E, C] token id in each slot, T if empty


def route(router: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig,
          cap: int) -> Routing:
    """Top-k routing of xt [T, D] and its capacity slots."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    logits = (xt @ router).float()                           # [T, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]            # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # slot = #prior (token, k) pairs routed to the same expert.  The
    # one-hot matrix is held [E, T*K] so that the count runs along its
    # inner dim: scanning [T*K, E] along its outer dim took 554 ms of a
    # 774 ms granite-moe prefill of 8 x 1024 tokens on an H100 80GB HBM3
    # at 700 W (PERF.md).  Each pair reads its own expert's row.
    expert_of = gate_idx.reshape(t * k)
    oh_t = (torch.arange(e, device=xt.device)[:, None] == expert_of[None, :]
            ).to(torch.int32)                                # [E, T*K]
    seen = torch.cumsum(oh_t, dim=1, dtype=torch.int32)
    slot_of = seen.gather(0, expert_of[None, :])[0] - 1      # [T*K]
    keep = slot_of < cap

    # scatter the token ids into the [E, C + 1] slot table (slot C: dump)
    src_tok = torch.arange(t, device=xt.device)[:, None].expand(t, k)
    slot_clip = torch.where(keep, slot_of, cap)
    slot_token = torch.full((e, cap + 1), t, dtype=torch.int64,
                            device=xt.device)
    slot_token.view(-1).scatter_(0, expert_of * (cap + 1) + slot_clip,
                                 src_tok.reshape(t * k))
    return Routing(logits, probs, gate_vals, gate_idx, slot_of, keep,
                   slot_token[:, :cap])


def moe_forward(p, x, cfg: MoEConfig, shard: str = "ep"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss [] f32)."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt = x.reshape(t, d)
    cap = _capacity(t, cfg)
    r = route(p["router"], xt, cfg, cap)

    # dispatch: gather token rows into [E, C, D] (row T: zeros)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = xt_pad.index_select(0, r.slot_token.reshape(-1)).reshape(
        cfg.n_experts, cap, d)

    # expert FFN: batched GEMMs over the expert dim
    g = torch.nn.functional.silu(torch.bmm(xe, p["w_gate"]))
    u = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(g * u, p["w_down"])                       # [E, C, D]

    # combine: each pair gathers its slot (a dropped one slot C - 1, x 0)
    flat = r.gate_idx.reshape(t * k) * cap + torch.clamp(r.slot_of,
                                                         max=cap - 1)
    contrib = ye.reshape(-1, d).index_select(0, flat)        # [T*K, D]
    w_of = r.gate_vals.reshape(t * k) * r.keep
    contrib = contrib * w_of[:, None].to(contrib.dtype)
    out = contrib.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared:
        out = out + swiglu(xt, p["shared_gate"], p["shared_up"],
                           p["shared_down"])

    # aux losses
    me = r.probs.mean(dim=0)                                 # mean router prob
    ce = torch.zeros_like(me).index_add_(
        0, r.gate_idx.reshape(-1), torch.ones_like(r.gate_vals).reshape(-1)
    ) / t                                                    # frac routed
    balance = cfg.n_experts * torch.sum(me * ce) * cfg.balance_coef
    z = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1))) \
        * cfg.z_coef
    return out.reshape(b, s, d).to(x.dtype), balance + z
