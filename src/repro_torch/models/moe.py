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

Aux losses: load-balance (Switch) + router z-loss.  The ``shard``
argument ("ep" or "tp") places the dispatch buffers on a mesh: under a
sharding policy ``constrain`` puts the expert dim ("ep") or the FFN inner
dim ("tp") over the model axis, as the reference's constraints do; with
no policy it changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.distribution.sharding import (constrain, like, replicate,
                                               replicate_grad, to_local)
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
    """Top-k routing of xt [T, D] and its capacity slots.  Under a
    sharding policy the router's logits are gathered whole, so every rank
    routes all T tokens; the slot assignment (no DTensor rule for its
    one-hot count and scatter) runs on each rank's local copy of the
    expert ids and comes back as replicated DTensors."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    logits = replicate((xt @ router).float())                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # the ranking carries no gradient; the gates are gathered from probs
    # (the sort's own backward builds a plain zeros tensor, which DTensor
    # refuses to mix with its gradient in torch 2.11)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices
    gate_idx = idx[:, :k]                                    # [T, K]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    slots = _slots(to_local(gate_idx.reshape(t * k)), t, e, k, cap)
    return Routing(logits, probs, gate_vals, gate_idx,
                   *(like(x, logits) for x in slots))


def _slots(expert_of: torch.Tensor, t: int, e: int, k: int, cap: int):
    """(slot_of [T*K], keep [T*K], slot_token [E, C]) of the flattened
    (token, k) pairs' experts."""
    # slot = #prior (token, k) pairs routed to the same expert.  The
    # one-hot matrix is held [E, T*K] so that the count runs along its
    # inner dim: scanning [T*K, E] along its outer dim took 554 ms of a
    # 774 ms granite-moe prefill of 8 x 1024 tokens on an H100 80GB HBM3
    # at 700 W (PERF.md).  Each pair reads its own expert's row.
    dev = expert_of.device
    oh_t = (torch.arange(e, device=dev)[:, None] == expert_of[None, :]
            ).to(torch.int32)                                # [E, T*K]
    seen = torch.cumsum(oh_t, dim=1, dtype=torch.int32)
    slot_of = seen.gather(0, expert_of[None, :])[0] - 1      # [T*K]
    keep = slot_of < cap

    # scatter the token ids into the [E, C + 1] slot table (slot C: dump)
    src_tok = torch.arange(t, device=dev)[:, None].expand(t, k)
    slot_clip = torch.where(keep, slot_of, cap)
    slot_token = torch.full((e, cap + 1), t, dtype=torch.int64, device=dev)
    slot_token.view(-1).scatter_(0, expert_of * (cap + 1) + slot_clip,
                                 src_tok.reshape(t * k))
    return slot_of, keep, slot_token[:, :cap]


def moe_forward(p, x, cfg: MoEConfig, shard: str = "ep"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss [] f32)."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt = constrain(x.reshape(t, d), "batch", None)
    cap = _capacity(t, cfg)
    ep = "ep" if shard == "ep" else None
    tp = "tp" if shard == "tp" else None
    r = route(p["router"], xt, cfg, cap)
    slot_token = constrain(r.slot_token, ep, None, divisible_dims=False)

    # dispatch: gather token rows into [E, C, D] (row T: zeros)
    whole = replicate(xt)
    pad = torch.zeros((1, d), dtype=whole.dtype, device=whole.device)
    xt_pad = torch.cat([whole, like(pad, whole)])
    xe = replicate_grad(xt_pad.index_select(
        0, replicate(slot_token).reshape(-1))).reshape(cfg.n_experts, cap, d)
    xe = constrain(xe, ep, None, None, divisible_dims=False)

    # expert FFN: batched GEMMs over the expert dim
    g = torch.nn.functional.silu(torch.bmm(xe, p["w_gate"]))
    u = torch.bmm(xe, p["w_up"])
    g = constrain(g, ep, None, tp, divisible_dims=False)
    ye = torch.bmm(g * u, p["w_down"])                       # [E, C, D]
    ye = constrain(ye, ep, None, None, divisible_dims=False)

    # combine: each pair gathers its slot (a dropped one slot C - 1, x 0)
    flat = r.gate_idx.reshape(t * k) * cap + torch.clamp(r.slot_of,
                                                         max=cap - 1)
    contrib = replicate_grad(replicate(replicate(ye).reshape(
        -1, d)).index_select(0, flat))                       # [T*K, D]
    contrib = constrain(contrib, "batch", None)
    w_of = r.gate_vals.reshape(t * k) * r.keep
    contrib = contrib * w_of[:, None].to(contrib.dtype)
    out = contrib.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared:
        out = out + swiglu(xt, p["shared_gate"], p["shared_up"],
                           p["shared_down"])

    # aux losses
    me = r.probs.mean(dim=0)                                 # mean router prob
    # the routed counts (no gradient) on each rank's local copy of the
    # expert ids under a policy: DTensor has no rule for ``index_add_``
    routed = to_local(r.gate_idx).reshape(-1)
    ce = like(torch.zeros(cfg.n_experts, device=routed.device).index_add_(
        0, routed, torch.ones(routed.shape, device=routed.device)), me) / t
    balance = cfg.n_experts * torch.sum(me * ce) * cfg.balance_coef
    z = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1))) \
        * cfg.z_coef
    return out.reshape(b, s, d).to(x.dtype), balance + z
