"""Gradient compression for cross-pod sync: error-feedback int8 + top-k —
the port of ``repro/optim/compression.py``.

Two standard compressors, both with error feedback (the quantization or
sparsification residual is carried to the next step, which keeps SGD
convergence — Karimireddy et al. 2019):

  int8:  per-tensor symmetric scale, 4x fewer bytes on the wire;
  topk:  keep the largest |g| fraction per tensor, 1/frac fewer bytes.

``compress_tree`` -> (payload tree, new error tree); the payload is what a
launcher would all-reduce across pods; ``decompress_tree`` restores
float32.  The roundtrip (decompress . compress) runs in-step, so the
numerics are exercised end to end on one device.

The arithmetic is the reference's: the int8 scale is
``max(max|g|, 1e-12) / 127`` and ``g / scale`` a true float32 division
(on the card ``tensor / python float`` would multiply by a reciprocal, so
both divisors are device tensors), rounded half to even; top-k keeps
``lax.top_k``'s order, larger |g| first and the lower index first among
equal ones (a stable descending sort), with int32 indices.  Trees are
walked in the JAX package's leaf order (``models/common.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"               # "int8" | "topk" | "none"
    topk_frac: float = 0.01


def ef_init(params):
    """Zero float32 error-feedback buffers shaped like the grads."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _int8_compress(g: torch.Tensor) -> Tuple[dict, torch.Tensor]:
    top = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = top / torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return dict(q=q, scale=scale), g - deq


def _int8_decompress(payload: dict) -> torch.Tensor:
    return payload["q"].float() * payload["scale"]


def _topk_compress(g: torch.Tensor, frac: float
                   ) -> Tuple[dict, torch.Tensor]:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, order = torch.sort(torch.abs(flat), descending=True, stable=True)
    idx = order[:k]
    kept = flat[idx]
    deq = torch.zeros_like(flat).index_copy_(0, idx, kept)
    return dict(idx=idx.to(torch.int32), vals=kept,
                shape=tuple(g.shape)), g - deq.reshape(g.shape)


def _topk_decompress(payload: dict) -> torch.Tensor:
    n = 1
    for s in payload["shape"]:
        n *= s
    vals = payload["vals"]
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out.index_copy_(0, payload["idx"].long(), vals)
    return out.reshape(payload["shape"])


def compress_tree(grads, err, cfg: CompressionConfig):
    """(grads + err) -> (payload tree, new err tree), both in ``grads``'
    nesting."""
    if cfg.kind == "none":
        return grads, err
    payloads, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        corrected = g.float() + e
        if cfg.kind == "int8":
            p, r = _int8_compress(corrected)
        elif cfg.kind == "topk":
            p, r = _topk_compress(corrected, cfg.topk_frac)
        else:
            raise ValueError(cfg.kind)
        payloads.append(p)
        new_err.append(r)
    return tree_unflatten(grads, payloads), tree_unflatten(grads, new_err)


def _is_payload(node) -> bool:
    return isinstance(node, dict) and ("q" in node or "idx" in node)


def decompress_tree(payloads, cfg: CompressionConfig, like=None):
    if cfg.kind == "none":
        return payloads
    fn = _int8_decompress if cfg.kind == "int8" else _topk_decompress

    def walk(node):
        if _is_payload(node):
            return fn(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(payloads)


def roundtrip(grads, err, cfg: CompressionConfig):
    """compress -> decompress (what each pod sees after the wire)."""
    payloads, err = compress_tree(grads, err, cfg)
    return decompress_tree(payloads, cfg), err


def wire_bytes(payloads, cfg: CompressionConfig) -> int:
    """Bytes a pod puts on the cross-pod link for this payload tree (a
    top-k payload's static ``shape`` is not sent)."""
    if isinstance(payloads, torch.Tensor):
        return payloads.numel() * payloads.element_size()
    if isinstance(payloads, dict):
        payloads = payloads.values()
    elif not isinstance(payloads, (list, tuple)):
        return 0                                        # a shape's int
    return sum(wire_bytes(v, cfg) for v in payloads)
