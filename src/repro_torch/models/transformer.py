"""Decoder-only transformer LM, serving half: GQA/MLA attention, dense/MoE
FFN — the port of ``repro/models/transformer.py``'s init, forward,
init_cache, decode_step and prefill.

One code path covers all five LM architectures; the config selects the
attention flavour (GQA incl. MHA, or DeepSeek-V2 MLA) and the FFN flavour
(SwiGLU dense, or shared + routed top-k MoE).

The parameters are a ``ParamTree`` whose names are the JAX pytree's paths
(``embed``, ``final_norm``, ``layers.attn.wq``, ``layers.ffn.w_gate``,
``lm_head`` when untied): the per-layer leaves are stacked ``[L, ...]``,
as the reference's ``vmap``-ed init makes them, and the layers run as a
Python loop over views of them.  Nothing here is differentiated (the
reference's remat only serves training).

The KV cache is a dict of stacked ``[L, B, ..., max_len, D]`` tensors
(``k``/``v``, or ``c_kv``/``k_rope`` for MLA); ``decode_step`` writes the
new token into it in place, layer by layer, where the reference carries
it through its layer scan.  ``cache_len`` is a host int.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import generator, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import MLAConfig
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.moe import MoEConfig


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def mla_config(cfg: LMConfig) -> MLAConfig:
    return MLAConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)


def moe_config(cfg: LMConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model, d_ff_expert=cfg.d_ff_expert,
        n_experts=cfg.n_experts, top_k=cfg.top_k, n_shared=cfg.n_shared,
        capacity_factor=cfg.capacity_factor)


# ------------------------------------------------------------------- init ---

def _stacked(spec, n: int):
    """A one-layer spec with every leaf given a leading layer dim of n."""
    if isinstance(spec, dict):
        return {k: _stacked(v, n) for k, v in spec.items()}
    if spec[0] == "dense":
        return ("normal", (n, spec[1], spec[2]), 1.0 / math.sqrt(spec[1]))
    return (spec[0], (n,) + tuple(spec[1])) + tuple(spec[2:])


def _spec(cfg: LMConfig) -> dict:
    d = cfg.d_model
    if cfg.attn == "mla":
        attn = attn_mod.mla_spec(mla_config(cfg))
    else:
        attn = attn_mod.gqa_spec(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if cfg.moe:
        ffn = moe_mod.moe_spec(moe_config(cfg))
    else:
        ffn = dict(w_gate=("dense", d, cfg.d_ff), w_up=("dense", d, cfg.d_ff),
                   w_down=("dense", cfg.d_ff, d))
    layer = dict(ln1=("ones", (d,)), ln2=("ones", (d,)), attn=attn, ffn=ffn)
    spec = dict(embed=("normal", (cfg.vocab, d), 0.02),
                final_norm=("ones", (d,)),
                layers=_stacked(layer, cfg.n_layers))
    if not cfg.tie_embeddings:
        spec["lm_head"] = ("normal", (cfg.vocab, d), 0.02)
    return spec


def init(seed: int, cfg: LMConfig, *, device=None) -> common.ParamTree:
    """Random parameters in ``cfg.dtype``, drawn on ``device`` (default:
    the CUDA device; raises without one) from a generator seeded with
    ``seed``; their count is ``cfg.n_params``."""
    dev = resolve_device(device)
    tree = common.materialize(_spec(cfg), generator(seed, dev), _dtype(cfg))
    return common.ParamTree(tree)


def params_from_numpy(tree: dict, device=None) -> common.ParamTree:
    """The JAX parameter pytree as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's module, leaf for
    leaf, on ``device`` (default: the CUDA device)."""
    return common.ParamTree(common.tree_from_numpy(tree,
                                                   resolve_device(device)))


def params_to_numpy(params: common.ParamTree) -> dict:
    return common.tree_to_numpy(params)


def _layers(params) -> list:
    """Per-layer views of the stacked ``layers`` leaves, as nested dicts."""
    stacked = common.to_tree(params.layers)
    n = stacked["ln1"].shape[0]

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]
    return [pick(stacked, i) for i in range(n)]


# ---------------------------------------------------------------- forward ---

def _layer_forward(lp, x, cfg: LMConfig, positions):
    """One layer of the full path: (x, aux, cache entries of the layer)."""
    h = rms_norm(x, lp["ln1"])
    if cfg.attn == "mla":
        attn_out, (c_kv, k_rope) = attn_mod.mla_forward(
            lp["attn"], h, mla_config(cfg), positions, chunk=cfg.attn_chunk)
        cache = dict(c_kv=c_kv, k_rope=k_rope)
    else:
        attn_out, (k, v) = attn_mod.gqa_forward(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            positions=positions, chunk=cfg.attn_chunk)
        cache = dict(k=k, v=v)
    x = x + attn_out
    h = rms_norm(x, lp["ln2"])
    if cfg.moe:
        f, aux = moe_mod.moe_forward(lp["ffn"], h, moe_config(cfg),
                                     shard=cfg.moe_shard)
    else:
        f = swiglu(h, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                   lp["ffn"]["w_down"])
        aux = torch.zeros((), device=x.device)
    return x + f, aux, cache


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    flat = params.embed.index_select(0, tokens.reshape(-1))
    return flat.reshape(*tokens.shape, -1)


def _logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = rms_norm(x, params.final_norm)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return x @ head.T


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss [] f32)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, tokens)
    aux = torch.zeros((), device=x.device)
    for lp in _layers(params):
        x, a, _ = _layer_forward(lp, x, cfg, positions)
        aux = aux + a
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------- serving ---

def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Zeroed stacked KV cache [L, ...] (decode_step's input layout) on
    ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    dt, n = _dtype(cfg), cfg.n_layers
    if cfg.attn == "mla":
        return dict(
            c_kv=torch.zeros((n, batch, max_len, cfg.kv_lora_rank), dtype=dt,
                             device=dev),
            k_rope=torch.zeros((n, batch, max_len, cfg.qk_rope_dim),
                               dtype=dt, device=dev))
    shape = (n, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return dict(k=torch.zeros(shape, dtype=dt, device=dev),
                v=torch.zeros(shape, dtype=dt, device=dev))


def decode_step(params, token: torch.Tensor, cache: dict, cache_len: int,
                cfg: LMConfig) -> Tuple[torch.Tensor, dict]:
    """One serving step: token [B, 1] + cache -> (logits [B, V], cache).

    ``cache_len`` (a host int) is the number of valid positions already in
    the cache; the new token is written at that offset (clamped to the
    last slot), in place.  The returned cache is the one passed in.
    """
    x = _embed(params, token)
    for i, lp in enumerate(_layers(params)):
        cache_l = {k: v[i] for k, v in cache.items()}
        h = rms_norm(x, lp["ln1"])
        if cfg.attn == "mla":
            out, _ = attn_mod.mla_decode(lp["attn"], h, cache_l, cache_len,
                                         mla_config(cfg))
        else:
            out, _ = attn_mod.gqa_decode(
                lp["attn"], h, cache_l, cache_len, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta)
        x = x + out
        h = rms_norm(x, lp["ln2"])
        if cfg.moe:
            f, _ = moe_mod.moe_forward(lp["ffn"], h, moe_config(cfg),
                                       shard=cfg.moe_shard)
        else:
            f = swiglu(h, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                       lp["ffn"]["w_down"])
        x = x + f
    return _logits(params, x[:, 0], cfg), cache


def prefill(params, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int = 0) -> Tuple[torch.Tensor, dict, int]:
    """Prompt pass: tokens [B, S] -> (last logits [B, V], cache [L, B, ...,
    max_len, D], cache_len = S).

    ``cfg.prefill_microbatch`` > 0 runs the batch in chunks of that many
    rows (when it splits the batch into two or more), each chunk's caches
    written into its rows of the one stacked cache.
    """
    b, s = tokens.shape
    max_len = max_len or s
    mb = cfg.prefill_microbatch or b
    n_chunks = max(b // mb, 1)
    if n_chunks == 1:
        mb = b
    elif n_chunks * mb != b:
        raise ValueError(f"prefill: batch {b} is not a multiple of "
                         f"prefill_microbatch {mb}")
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    layers = _layers(params)
    logits = []
    for c in range(n_chunks):
        rows = slice(c * mb, (c + 1) * mb)
        x = _embed(params, tokens[rows])
        positions = _positions(mb, s, tokens.device)
        for i, lp in enumerate(layers):
            x, _, entries = _layer_forward(lp, x, cfg, positions)
            for name, t in entries.items():
                cache[name][i, rows].narrow(-2, 0, s).copy_(t)
        logits.append(_logits(params, x[:, -1], cfg))
    return torch.cat(logits), cache, s
