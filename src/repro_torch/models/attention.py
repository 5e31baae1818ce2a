"""Attention: chunked (flash-style) softmax attention, GQA and MLA variants —
the port of ``repro/models/attention.py``.

``chunked_attention`` runs the online-softmax recurrence over KV chunks,
carrying the running (max, denominator, accumulator) triple in float32, so
the score matrix is never held whole: O(S * chunk) per head.  The scores,
probabilities and accumulator stay float32 in every model dtype, as in
the reference (``scaled_dot_product_attention`` would keep bf16
probabilities on its bf16 path).

MLA (DeepSeek-V2) has the naive full path (prefill) and the *absorbed*
decode path that attends in the kv_lora latent space, caching only
(c_kv, k_rope) = kv_lora + rope_dim values per token.

Decode writes the new token's keys in place into the caller's cache at
``cache_len``, clamped to the last slot as ``dynamic_update_slice_in_dim``
clamps its start: a write at ``cache_len >= max_len`` lands at
``max_len - 1``.  ``cache_len`` is a 0-d int32 device tensor there (a host
int is accepted and filled on the device), as the reference's traced
length is: the decode path makes the host wait for nothing, and a
captured step reads the length its replay is given.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distribution.sharding import constrain, index_copy_, like
from repro_torch.models import common
from repro_torch.models.common import apply_rope

MASK_VALUE = -1e30


# ----------------------------------------------------------- core softmax ---

def chunked_attention(q, k, v, *, causal: bool, chunk: int = 512,
                      q_offset=0):
    """Online-softmax attention.

    q [B, Hkv, G, Sq, Dk]; k [B, Hkv, Skv, Dk]; v [B, Hkv, Skv, Dv]
    (G = query groups per kv head; G=1, Hkv=H recovers MHA).
    ``q_offset`` is the absolute position of q[..., 0, :] for causal
    masking.  Returns [B, Hkv, G, Sq, Dv] in q's dtype.
    """
    b, hkv, g, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    assert skv % chunk == 0, (skv, chunk)
    dev = q.device

    qf = _batch_only(q.float() / math.sqrt(dk))
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = like(torch.full((b, hkv, g, sq), -math.inf, device=dev), q)
    den = like(torch.zeros((b, hkv, g, sq), device=dev), q)
    acc = like(torch.zeros((b, hkv, g, sq, dv), device=dev), q)
    for c in range(skv // chunk):
        kb = _batch_only(k[:, :, c * chunk:(c + 1) * chunk].float())
        vb = _batch_only(v[:, :, c * chunk:(c + 1) * chunk].float())
        s = _grouped_bmm(qf, kb.transpose(-1, -2))        # [B,H,G,Sq,chunk]
        if causal:
            k_pos = c * chunk + torch.arange(chunk, device=dev)
            s = torch.where(like(q_pos[:, None] >= k_pos[None, :], s), s,
                            MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        den = den * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + _grouped_bmm(p, vb)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return _batch_only(out.to(q.dtype))


def _grouped_bmm(a, b):
    """a [B, H, G, M, K] @ b [B, H, K, N] -> [B, H, G, M, N], each kv
    head's G query groups sharing its b: the reference's einsums as one
    ``bmm``, every reshape between two batch-only constraints (forward
    and gradient) under a sharding policy."""
    bb, h, g, m, k = a.shape
    n = b.shape[-1]
    out = torch.bmm(_batch_only(_batch_only(a).reshape(bb * h, g * m, k)),
                    _batch_only(_batch_only(b).reshape(bb * h, k, n)))
    return _batch_only(_batch_only(out).reshape(bb, h, g, m, n))


def _valid(cache_len, s: int, device):
    """[S] or [B, 1, 1, S] mask of the cache positions below
    ``cache_len`` (a host int, a 0-d tensor or a [B] tensor)."""
    pos = like(torch.arange(s, device=device), cache_len)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        return (pos[None, :] < cache_len[:, None])[:, None, None, :]
    return pos < cache_len


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention against a (possibly partially filled) cache.

    q [B, Hkv, G, Dk]; caches [B, Hkv, S, D*]; cache_len a host int, a
    0-d or a [B] tensor — the number of valid cache positions (the new
    token attends to [0, cache_len)).  The two products are the
    reference's einsums as ``_grouped_bmm``s, so under a sharding policy a
    cache sharded over its sequence is gathered whole first.
    """
    dk = q.shape[-1]
    qf = q.float()[:, :, :, None] / math.sqrt(dk)          # [B,H,G,1,Dk]
    scores = _grouped_bmm(qf, k_cache.float().transpose(-1, -2))[
        :, :, :, 0]                                         # [B,H,G,S]
    scores = torch.where(_valid(cache_len, k_cache.shape[2], q.device),
                         scores, MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = _grouped_bmm(p[:, :, :, None], v_cache.float())[:, :, :, 0]
    return out.to(q.dtype)


def as_length(cache_len, device) -> torch.Tensor:
    """``cache_len`` as a 0-d int32 tensor on ``device``: a tensor cast, a
    host int filled on the device (a fill, not a copy from the host)."""
    if isinstance(cache_len, torch.Tensor):
        return cache_len.to(device=device, dtype=torch.int32)
    return torch.full((), int(cache_len), dtype=torch.int32, device=device)


def _write(cache: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor,
           dim: int) -> None:
    """``dynamic_update_slice_in_dim`` of one position along ``dim``, in
    place: the start (a 0-d device tensor) clamped into [0, size - 1]."""
    at = torch.clamp(cache_len, 0, cache.shape[dim] - 1).reshape(1)
    index_copy_(cache, dim, at.long(), new)


# ------------------------------------------------------------------- GQA ----

def _batch_only(x):
    """``x`` with its batch (dim 0) sharded and every other dim whole
    under a sharding policy (the identity without one), forward and
    gradient: DTensor refuses to merge batch and heads into one dim when
    both are sharded, and may pick such placements for a gradient."""
    return constrain(x, "batch", *[None] * (x.ndim - 1))


def _heads_whole(x):
    """A projection's output [B, S, heads * d] with its batch sharded
    and its heads whole under a sharding policy (the identity without
    one): DTensor cannot split a sharded dim into heads the mesh axis
    does not divide, nor let the attention's einsums flatten batch and
    heads when both are sharded."""
    return constrain(x, "batch", None, None)


def gqa_spec(d_model: int, n_heads: int, n_kv_heads: int,
             d_head: int) -> dict:
    return dict(wq=("dense", d_model, n_heads * d_head),
                wk=("dense", d_model, n_kv_heads * d_head),
                wv=("dense", d_model, n_kv_heads * d_head),
                wo=("dense", n_heads * d_head, d_model))


def gqa_init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int, d_head: int, dtype=torch.float32) -> dict:
    return common.materialize(gqa_spec(d_model, n_heads, n_kv_heads,
                                       d_head), gen, dtype)


def gqa_forward(p, x, *, n_heads: int, n_kv_heads: int, d_head: int,
                rope_theta: float, positions, causal: bool = True,
                chunk: int = 512):
    """x [B, S, D] -> ([B, S, D], (k, v) [B, Hkv, S, Dh]); the full
    (prefill) path, k and v for the cache."""
    b, s, _ = x.shape
    g = n_heads // n_kv_heads
    q = _batch_only(_heads_whole(x @ p["wq"]).reshape(b, s, n_kv_heads, g,
                                                      d_head))
    k = _batch_only(_heads_whole(x @ p["wk"]).reshape(b, s, n_kv_heads,
                                                      d_head))
    v = _batch_only(_heads_whole(x @ p["wv"]).reshape(b, s, n_kv_heads,
                                                      d_head))
    q = apply_rope(q.permute(0, 2, 3, 1, 4), positions[:, None, None, :],
                   rope_theta)                       # [B,Hkv,G,S,Dh]
    k = apply_rope(k.permute(0, 2, 1, 3), positions[:, None, :],
                   rope_theta)                       # [B,Hkv,S,Dh]
    v = v.permute(0, 2, 1, 3)
    out = chunked_attention(q, k, v, causal=causal, chunk=min(chunk, s))
    out = _heads_whole(out.permute(0, 3, 1, 2, 4).reshape(b, s,
                                                          n_heads * d_head))
    return out @ p["wo"], (k, v)


def gqa_decode(p, x, cache, cache_len, *, n_heads: int,
               n_kv_heads: int, d_head: int, rope_theta: float):
    """x [B, 1, D]; cache dict(k, v) [B, Hkv, S, Dh], written in place at
    ``cache_len`` (a host int or a 0-d tensor).  Returns (out [B, 1, D],
    cache)."""
    b = x.shape[0]
    g = n_heads // n_kv_heads
    cache_len = as_length(cache_len, x.device)
    pos = cache_len.expand(b, 1)
    q = _batch_only(_heads_whole(x @ p["wq"]).reshape(b, 1, n_kv_heads, g,
                                                      d_head))
    k = _batch_only(_heads_whole(x @ p["wk"]).reshape(b, 1, n_kv_heads,
                                                      d_head))
    v = _batch_only(_heads_whole(x @ p["wv"]).reshape(b, 1, n_kv_heads,
                                                      d_head))
    q = apply_rope(q.permute(0, 2, 3, 1, 4), pos[:, None, None, :],
                   rope_theta)[:, :, :, 0]                   # [B,Hkv,G,Dh]
    k = apply_rope(k.permute(0, 2, 1, 3), pos[:, None, :], rope_theta)
    _write(cache["k"], k.to(cache["k"].dtype), cache_len, 2)
    _write(cache["v"], v.permute(0, 2, 1, 3).to(cache["v"].dtype),
           cache_len, 2)
    out = decode_attention(q, cache["k"], cache["v"], cache_len + 1)
    return out.reshape(b, 1, n_heads * d_head) @ p["wo"], cache


# ------------------------------------------------------------------- MLA ----

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int          # 0 = no q compression
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0


def mla_spec(cfg: MLAConfig) -> dict:
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    spec = dict(
        wkv_a=("dense", cfg.d_model, cfg.kv_lora_rank + dr),
        wkv_b=("dense", cfg.kv_lora_rank, h * (dn + dv)),
        wo=("dense", h * dv, cfg.d_model))
    if cfg.q_lora_rank:
        spec["wq_a"] = ("dense", cfg.d_model, cfg.q_lora_rank)
        spec["wq_b"] = ("dense", cfg.q_lora_rank, h * (dn + dr))
    else:
        spec["wq"] = ("dense", cfg.d_model, h * (dn + dr))
    return spec


def mla_init(gen: torch.Generator, cfg: MLAConfig,
             dtype=torch.float32) -> dict:
    return common.materialize(mla_spec(cfg), gen, dtype)


def _mla_q(p, x, cfg: MLAConfig):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["wq_a"]) @ p["wq_b"] if cfg.q_lora_rank else x @ p["wq"]
    q = _batch_only(_heads_whole(q).reshape(b, s, h, dn + dr))
    return q[..., :dn], q[..., dn:]            # nope [B,S,H,dn], rope


def mla_forward(p, x, cfg: MLAConfig, positions, causal: bool = True,
                chunk: int = 512):
    """Full path. Returns (out, (c_kv [B,S,R], k_rope [B,S,dr])) for the
    cache."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope.permute(0, 2, 1, 3), positions[:, None, :],
                        cfg.rope_theta)                    # [B,H,S,dr]

    ckv = _heads_whole(x @ p["wkv_a"])                     # [B,S,lora+dr]
    c_kv, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, None], positions[:, None, :],
                        cfg.rope_theta)                    # [B,1,S,dr]
    kv = _batch_only(_heads_whole(c_kv @ p["wkv_b"]).reshape(b, s, h,
                                                             dn + dv))
    k_nope, v = kv[..., :dn], kv[..., dn:]

    q = torch.cat([q_nope.permute(0, 2, 1, 3), q_rope], dim=-1)
    k = torch.cat([k_nope.permute(0, 2, 1, 3),
                   k_rope.expand(b, h, s, dr)], dim=-1)    # [B,H,S,dn+dr]
    out = chunked_attention(q[:, :, None], k, v.permute(0, 2, 1, 3),
                            causal=causal, chunk=min(chunk, s))[:, :, 0]
    out = _heads_whole(out.permute(0, 2, 1, 3).reshape(b, s, h * dv))
    return out @ p["wo"], (c_kv, k_rope[:, 0])


def mla_decode(p, x, cache, cache_len, cfg: MLAConfig):
    """Absorbed decode: attend in the kv_lora latent space.

    cache = dict(c_kv [B, S, R], k_rope [B, S, dr]), written in place at
    ``cache_len`` (a host int or a 0-d tensor).  Per-token cache cost is
    R + dr values (DeepSeek-V2's 576 vs GQA's 2*Hkv*Dh).
    """
    b = x.shape[0]
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    cache_len = as_length(cache_len, x.device)
    pos = cache_len.expand(b, 1)
    q_nope, q_rope = _mla_q(p, x, cfg)                     # [B,1,H,*]
    q_rope = apply_rope(q_rope.permute(0, 2, 1, 3), pos[:, None],
                        cfg.rope_theta)[:, :, 0]           # [B,H,dr]

    ckv = _heads_whole(x @ p["wkv_a"])
    c_new, kr_new = ckv[..., :r], ckv[..., r:]
    kr_new = apply_rope(kr_new, pos, cfg.rope_theta)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    _write(c_kv, c_new.to(c_kv.dtype), cache_len, 1)
    _write(k_rope, kr_new.to(k_rope.dtype), cache_len, 1)

    wkv_b = p["wkv_b"].reshape(r, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]          # [R,H,dn],[R,H,dv]
    # absorb: q_lat[b,h,r] = q_nope[b,h,dn] . w_uk[r,h,dn]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         w_uk.float())
    scale = 1.0 / math.sqrt(dn + dr)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                             k_rope.float())) * scale
    valid = like(torch.arange(c_kv.shape[1], device=x.device),
                 cache_len) < cache_len + 1
    scores = torch.where(valid, scores, MASK_VALUE)
    attn = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsr->bhr", attn, c_kv.float())
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv.float())
    out = ctx.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p["wo"], cache
