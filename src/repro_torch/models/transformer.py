"""Decoder-only transformer LM: GQA/MLA attention, dense/MoE FFN — the
port of ``repro/models/transformer.py``: init, forward, loss_fn,
make_train_step, init_cache, decode_step and prefill.

One code path covers all five LM architectures; the config selects the
attention flavour (GQA incl. MHA, or DeepSeek-V2 MLA) and the FFN flavour
(SwiGLU dense, or shared + routed top-k MoE).

The parameters are a ``ParamTree`` whose names are the JAX pytree's paths
(``embed``, ``final_norm``, ``layers.attn.wq``, ``layers.ffn.w_gate``,
``lm_head`` when untied): the per-layer leaves are stacked ``[L, ...]``,
as the reference's ``vmap``-ed init makes them, and the layers run as a
Python loop over views of them, one ``torch.unbind`` a leaf (whose
backward is one ``stack``; indexing each layer would zero and add a
whole ``[L, ...]`` gradient per layer).

Training: ``forward`` checkpoints each layer (``torch.utils.checkpoint``,
non-reentrant) under ``cfg.remat`` when autograd records, where the
reference takes ``jax.checkpoint``; ``make_train_step`` splits the batch
into ``cfg.num_microbatches`` contiguous microbatches and accumulates
their gradients in place in ``cfg.grad_accum_dtype``, then runs AdamW in
place.  The step makes the host wait for nothing.

The KV cache is a dict of stacked ``[L, B, ..., max_len, D]`` tensors
(``k``/``v``, or ``c_kv``/``k_rope`` for MLA); ``decode_step`` writes the
new token into it in place, layer by layer, where the reference carries
it through its layer scan.  ``cache_len`` is a 0-d int32 device tensor
(a host int is filled on the device).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.distribution.sharding import (constrain, current_policy,
                                               grad_as_forward, like,
                                               replicate,
                                               under_current_policy)
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import MLAConfig
from repro_torch.models.common import cross_entropy, rms_norm, swiglu
from repro_torch.models.moe import MoEConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update


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
    ``seed``; their count is ``cfg.n_params``.  On the ``meta`` device,
    their shapes only."""
    dev = resolve_device(device)
    tree = common.draw(_spec(cfg), seed, dev, _dtype(cfg))
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
    """Per-layer views of the stacked ``layers`` leaves, as nested dicts:
    one ``torch.unbind`` per leaf."""
    out = [{} for _ in range(params.layers.ln1.shape[0])]
    for name, leaf in params.layers.named_parameters():
        *path, key = name.split(".")
        for lp, view in zip(out, torch.unbind(leaf)):
            for k in path:
                lp = lp.setdefault(k, {})
            lp[key] = grad_as_forward(view)
    return out


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
    x = constrain(x + attn_out, "batch", None, None)
    h = rms_norm(x, lp["ln2"])
    if cfg.moe:
        f, aux = moe_mod.moe_forward(lp["ffn"], h, moe_config(cfg),
                                     shard=cfg.moe_shard)
    else:
        f = swiglu(h, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                   lp["ffn"]["w_down"])
        aux = like(torch.zeros((), device=x.device), x)
    return constrain(x + f, "batch", None, None), aux, cache


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    flat = replicate(replicate(params.embed).index_select(
        0, replicate(tokens).reshape(-1)))
    return constrain(flat.reshape(*tokens.shape, -1), "batch", None, None)


def _logits(params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = rms_norm(x, params.final_norm)
    # the head's gradient comes back under its own placements, so a tied
    # table's two gradients meet alike (DTensor may not add them else)
    head = grad_as_forward(params.embed if cfg.tie_embeddings
                           else params.lm_head)
    logits = x @ head.T
    spec = ("batch", None, "tp") if logits.ndim == 3 else ("batch", "tp")
    return constrain(logits, *spec)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss [] f32).  Under
    ``cfg.remat``, while autograd records, each layer keeps only its input
    and is recomputed in the backward."""
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = like(_positions(b, s, tokens.device), x)

    def body(x, lp):
        x, a, _ = _layer_forward(lp, x, cfg, positions)
        return x, a

    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    aux = like(torch.zeros((), device=x.device), x)
    for lp in _layers(params):
        if remat:
            # no layer draws a random number: nothing to replay
            x, a = torch.utils.checkpoint.checkpoint(
                under_current_policy(body), x, lp, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, a = body(x, lp)
        aux = aux + a
    return _logits(params, x, cfg), aux


def loss_fn(params, batch: dict, cfg: LMConfig):
    """(cross entropy + aux loss, dict(loss=cross entropy, aux=aux))."""
    logits, aux = forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, dict(loss=ce, aux=aux)


# --------------------------------------------------------------- training ---

def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig, lr_schedule=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics); params
    and moments are updated in place.

    ``cfg.num_microbatches`` = nm > 1 splits the batch on dim 0 into nm
    contiguous microbatches and accumulates their gradients in
    ``cfg.grad_accum_dtype``, then divides by nm.  The metrics are the
    reference's: with nm == 1 ``loss`` is the cross entropy, ``aux`` the
    aux loss and ``total`` their sum; with nm > 1 ``loss`` and ``total``
    are the mean over microbatches of cross entropy + aux, and ``aux`` is
    0.  ``lr_schedule``, when given, maps the step count to the lr.
    """
    nm = cfg.num_microbatches
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def grad_fn(params, batch):
        (loss, metrics), (grads,) = common.value_and_grad(
            lambda p: loss_fn(p, batch, cfg), params)
        return loss, metrics, grads

    def step(params, opt_state, batch):
        if nm == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % nm:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"num_microbatches {nm}")
            # zeros_like keeps a sharded parameter's placements; a
            # sharded batch is gathered before it is cut (its rows go
            # back over the batch axes at the embedding's constraint)
            acc = [torch.zeros_like(p, dtype=acc_dt)
                   for p in common.tree_leaves(params)]
            loss = None
            for i in range(nm):
                mb = {k: replicate(v).reshape(nm, b // nm, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = grad_fn(params, mb)
                for a, x in zip(acc, common.tree_leaves(g)):
                    # into a float32 accumulator a 16-bit gradient widens
                    # exactly, so it is added as it is (no widened copy);
                    # into a 16-bit one it is rounded first, as the
                    # reference's ``a + x.astype(acc_dt)``
                    a.add_(x if acc_dt == torch.float32 else x.to(acc_dt))
                del g
                loss = l if loss is None else loss + l
            grads = common.tree_unflatten(params, [a.div_(nm) for a in acc])
            loss = loss / nm
            metrics = dict(loss=loss, aux=torch.zeros_like(loss))
        lr = lr_schedule(opt_state["count"]) if lr_schedule else None
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg, lr)
        return params, opt_state, dict(metrics, total=loss, gnorm=gnorm)

    return step


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


def cache_axes(cfg: LMConfig, policy, max_len: int) -> dict:
    """The logical axes of each stacked cache leaf [L, B, ...] under
    ``policy`` (the reference's cache shardings): batch always; the model
    axis on the kv-head dim when it divides the kv heads, else on the
    sequence dim when it divides ``max_len``."""
    tp = policy.tp_axis
    tpsize = policy.axis_size("tp") if tp else 1
    s_ax = "tp" if tp and max_len % tpsize == 0 else None
    if cfg.attn == "mla":
        return dict(c_kv=(None, "batch", s_ax, None),
                    k_rope=(None, "batch", s_ax, None))
    if tp and cfg.n_kv_heads % tpsize == 0:
        axes = (None, "batch", "tp", None, None)
    else:
        axes = (None, "batch", None, s_ax, None)
    return dict(k=axes, v=axes)


def _stacked_cache(chunks: list, cfg: LMConfig, max_len: int) -> dict:
    """The stacked cache [L, B, ..., max_len, D] built from each chunk's
    per-layer entries (batch chunks joined, the sequence padded with
    zeros to ``max_len``), under the policy's cache axes: a prefill on
    DTensors, where writing into slices of one sharded cache is not a
    view DTensor keeps."""
    pol = current_policy()
    axes = cache_axes(cfg, pol, max_len)
    out = {}
    for name in chunks[0][0]:
        layers = []
        for i in range(len(chunks[0])):
            t = torch.cat([c[i][name] for c in chunks]).to(_dtype(cfg))
            pad = max_len - t.shape[-2]
            if pad:
                shape = t.shape[:-2] + (pad, t.shape[-1])
                t = torch.cat([t, like(torch.zeros(
                    shape, dtype=t.dtype, device=t.device), t)], dim=-2)
            layers.append(t)
        out[name] = constrain(torch.stack(layers), *axes[name])
    return out


def decode_step(params, token: torch.Tensor, cache: dict, cache_len,
                cfg: LMConfig) -> Tuple[torch.Tensor, dict]:
    """One serving step: token [B, 1] + cache -> (logits [B, V], cache).

    ``cache_len`` (a 0-d int32 device tensor, or a host int filled on the
    device) is the number of valid positions already in the cache; the new
    token is written at that offset (clamped to the last slot), in place.
    The returned cache is the one passed in.  The step reads nothing on
    the host, so it can be captured (``launch/serve.py``).
    """
    cache_len = attn_mod.as_length(cache_len, token.device)
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
    written into its rows of the one stacked cache.  Under a sharding
    policy the cache is built from the chunks' entries instead, under
    ``cache_axes`` (``_stacked_cache``).
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
    sharded = current_policy() is not None
    cache = None if sharded else init_cache(cfg, b, max_len,
                                            device=tokens.device)
    layers = _layers(params)
    logits, chunks = [], []
    for c in range(n_chunks):
        rows = slice(c * mb, (c + 1) * mb)
        x = _embed(params, tokens[rows])
        positions = like(_positions(mb, s, tokens.device), x)
        entries = []
        for i, lp in enumerate(layers):
            x, _, e = _layer_forward(lp, x, cfg, positions)
            if sharded:
                entries.append(e)
                continue
            for name, t in e.items():
                cache[name][i, rows].narrow(-2, 0, s).copy_(t)
        chunks.append(entries)
        logits.append(_logits(params, x[:, -1], cfg))
    if sharded:
        cache = _stacked_cache(chunks, cfg, max_len)
    return torch.cat(logits), cache, s
