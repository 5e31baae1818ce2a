"""Shared model building blocks: initialisers and the parameter tree.

A model of the port is a ``ParamTree``: an ``nn.Module`` built from the
JAX package's parameter pytree (nested dicts and lists of arrays), whose
``named_parameters()`` are the pytree's paths — ``table``, ``cross.0.w``,
``layers.3.edge_mlp.1.w``.  Dict entries become attributes, lists become
``nn.ModuleList``s, arrays become parameters (a 0-d array a 0-d
parameter).  ``tree_from_numpy`` / ``tree_to_numpy`` carry parameters
between the two packages as numpy arrays.

``cross_entropy`` is the LM loss (float32 log-sum-exp minus the gold
logit, 0 for a label outside the vocabulary, plus an optional z-loss);
``count_params`` counts a tree's elements.

Training walks a tree — a ``ParamTree``, or nested dicts and lists of
tensors such as the optimizer's moments — in the JAX package's leaf order
(dict keys sorted, lists by index: ``tree_leaves``), and takes gradients
with ``value_and_grad``, which turns autograd on for the leaves only for
the one call: outside it no parameter requires grad, so the serving
functions build no graph.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from repro_torch import generator
from repro_torch.distribution.sharding import like, replicate


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32):
    """[d_in, d_out] normal weights scaled by 1/sqrt(d_in), drawn on
    ``gen``'s device."""
    scale = 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    """[vocab, d] normal weights scaled by 0.02, drawn on ``gen``'s
    device."""
    return torch.randn((vocab, d), generator=gen, dtype=dtype,
                       device=gen.device).mul_(0.02)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last dim, computed in float32 and cast back to
    ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: down( silu(x@gate) * (x@up) ), in ``x``'s dtype."""
    g = torch.nn.functional.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    """[d_head/2] inverse frequencies ``1 / theta ** (2i / d_head)`` in
    float32."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0):
    """Rotary embedding of x [..., S, D] at positions [..., S]
    (broadcastable), in float32 and cast back to ``x``'s dtype; the two
    rotated halves are the first and second half of D."""
    inv = like(rope_freqs(x.shape[-1], theta, x.device), x)
    ang = positions[..., None].float() * inv                 # [..., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean over every position of ``logsumexp(logits) - logits[label]``
    (plus ``z_loss * logsumexp**2``), computed in float32.  A label outside
    ``[0, V)`` (``-1`` padding, say) has gold logit 0, as the reference's
    iota-mask sum gives: the gather reads a clamped index and a ``where``
    zeroes it, value and gradient."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    idx = replicate(labels)[..., None].long()
    inside = (idx >= 0) & (idx < v)
    gold = torch.where(inside, torch.gather(replicate(logits), -1,
                                            idx.clamp(0, v - 1)), 0.0)[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def count_params(params) -> int:
    """The number of elements over every leaf of a tree."""
    return sum(int(p.numel()) for p in tree_leaves(params))


# A model's parameters are first described as a spec: the pytree's nesting
# with a leaf per array, one of
#   ("dense", d_in, d_out)    dense_init
#   ("normal", shape, scale)  standard normal times scale
#   ("zeros", shape)
#   ("ones", shape)
# ``materialize`` draws it (``draw``: from a seed, or on the ``meta``
# device its shapes only, the port's ``jax.eval_shape`` of an init);
# ``spec_shapes`` gives the shapes a converted pytree must have.

def draw(spec, seed: int, device: torch.device, dtype=torch.float32):
    """``materialize`` from a generator seeded with ``seed`` on
    ``device``; on ``meta``, empty tensors of the spec's shapes."""
    if device.type == "meta":
        return _map_spec(lambda s: torch.empty(s, dtype=dtype,
                                               device=device),
                         spec_shapes(spec))
    return materialize(spec, generator(seed, device), dtype)


def _map_spec(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _map_spec(fn, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map_spec(fn, v) for v in shapes]
    return fn(shapes)


def materialize(spec, gen: torch.Generator, dtype=torch.float32):
    if isinstance(spec, dict):
        return {k: materialize(v, gen, dtype) for k, v in spec.items()}
    if isinstance(spec, list):
        return [materialize(v, gen, dtype) for v in spec]
    kind = spec[0]
    if kind == "dense":
        return dense_init(gen, spec[1], spec[2], dtype)
    if kind == "normal":
        return torch.randn(spec[1], generator=gen, dtype=dtype,
                           device=gen.device).mul_(spec[2])
    fill = torch.ones if kind == "ones" else torch.zeros
    return fill(spec[1], dtype=dtype, device=gen.device)


def spec_shapes(spec):
    if isinstance(spec, dict):
        return {k: spec_shapes(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [spec_shapes(v) for v in spec]
    return (spec[1], spec[2]) if spec[0] == "dense" else tuple(spec[1])


class ParamTree(nn.Module):
    """An ``nn.Module`` mirroring a nested dict/list parameter pytree."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            _attach(self, k, v)


def _node(v):
    if isinstance(v, dict):
        return ParamTree(v)
    if isinstance(v, (list, tuple)):
        return nn.ModuleList(_node(x) for x in v)
    return nn.Parameter(v, requires_grad=False)


def _attach(module: nn.Module, name: str, v) -> None:
    node = _node(v)
    if isinstance(node, nn.Parameter):
        module.register_parameter(name, node)
    else:
        module.add_module(name, node)


def to_tree(module: nn.Module):
    """A ``ParamTree`` as nested dicts/lists of its (detached) tensors."""
    if isinstance(module, nn.ModuleList):
        return [to_tree(m) for m in module]
    out = {k: p.detach() for k, p in module.named_parameters(recurse=False)}
    out.update({k: to_tree(m) for k, m in module.named_children()})
    return out


def tree_from_numpy(tree, device):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors on
    ``device`` (float arrays keep their dtype; a bfloat16 array, numpy's
    extension dtype from the JAX package, becomes a bfloat16 tensor)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_to_numpy(module: nn.Module) -> dict:
    """A ``ParamTree`` -> its pytree as nested dicts/lists of numpy arrays."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.cpu().numpy()
    return conv(to_tree(module))


def shapes(tree):
    """The nesting of ``tree`` with every array replaced by its shape."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shapes(v) for v in tree]
    return tuple(tree.shape)


# ------------------------------------------------------------------ trees --

def _children(node):
    """The (name, child) pairs of a tree node in the JAX package's leaf
    order, or None for a leaf."""
    if isinstance(node, (nn.ModuleList, list, tuple)):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        items = dict(node.named_parameters(recurse=False))
        items.update(node.named_children())
        return sorted(items.items())
    if isinstance(node, dict):
        return sorted(node.items())
    return None


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in the JAX package's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for _, c in kids for x in tree_leaves(c)]


def _rebuild(node, make):
    kids = _children(node)
    if kids is None:
        return make()
    if isinstance(node, (nn.ModuleList, list, tuple)):
        return [_rebuild(c, make) for _, c in kids]
    return {k: _rebuild(c, make) for k, c in kids}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of the
    ``rest``), as nested dicts and lists of ``tree``'s nesting: a module
    becomes a dict, a ``ModuleList`` a list."""
    it = iter(zip(tree_leaves(tree), *(tree_leaves(r) for r in rest)))
    return _rebuild(tree, lambda: fn(*next(it)))


def tree_unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s nesting."""
    it = iter(leaves)
    return _rebuild(tree, lambda: next(it))


def with_leaves(module: nn.Module, tree) -> nn.Module:
    """A shallow copy of a ``ParamTree`` (its class and attributes, such as
    a config) whose parameters are the tensors of ``tree``, a nested
    dict/list of its nesting."""
    new = copy.copy(module)
    new._parameters, new._modules = {}, {}
    for name in module._parameters:
        new.register_parameter(name, nn.Parameter(tree[name],
                                                  requires_grad=False))
    for name, child in module._modules.items():
        if isinstance(child, nn.ModuleList):
            new.add_module(name, nn.ModuleList(
                with_leaves(c, t) for c, t in zip(child, tree[name])))
        else:
            new.add_module(name, with_leaves(child, tree[name]))
    return new


def value_and_grad(fn, *trees):
    """``fn(*trees) -> (loss, aux)`` with autograd on for every leaf of
    ``trees`` during the call; returns ``((loss, aux), grads)``, loss and
    aux detached, ``grads`` one nested dict/list per tree (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives)."""
    per_tree = [tree_leaves(t) for t in trees]
    flat = [x for leaves in per_tree for x in leaves]
    with torch.enable_grad():
        for x in flat:
            x.requires_grad_(True)
        try:
            loss, aux = fn(*trees)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for x in flat:
                x.requires_grad_(False)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    out, at = [], 0
    for t, leaves in zip(trees, per_tree):
        out.append(tree_unflatten(t, grads[at:at + len(leaves)]))
        at += len(leaves)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tuple(out)
