"""Shared model building blocks: initialisers and the parameter tree.

A model of the port is a ``ParamTree``: an ``nn.Module`` built from the
JAX package's parameter pytree (nested dicts and lists of arrays), whose
``named_parameters()`` are the pytree's paths — ``table``, ``cross.0.w``,
``layers.3.edge_mlp.1.w``.  Dict entries become attributes, lists become
``nn.ModuleList``s, arrays become parameters (a 0-d array a 0-d
parameter).  ``tree_from_numpy`` / ``tree_to_numpy`` carry parameters
between the two packages as numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32):
    """[d_in, d_out] normal weights scaled by 1/sqrt(d_in), drawn on
    ``gen``'s device."""
    scale = 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                       device=gen.device).mul_(scale)


# A model's parameters are first described as a spec: the pytree's nesting
# with a leaf per array, one of
#   ("dense", d_in, d_out)    dense_init
#   ("normal", shape, scale)  standard normal times scale
#   ("zeros", shape)
# ``materialize`` draws it; ``spec_shapes`` gives the shapes a converted
# pytree must have.

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
    return torch.zeros(spec[1], dtype=dtype, device=gen.device)


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


def _to_tree(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_to_tree(m) for m in module]
    out = {k: p.detach() for k, p in module.named_parameters(recurse=False)}
    out.update({k: _to_tree(m) for k, m in module.named_children()})
    return out


def tree_from_numpy(tree, device):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors on
    ``device`` (float arrays keep their dtype)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def tree_to_numpy(module: nn.Module) -> dict:
    """A ``ParamTree`` -> its pytree as nested dicts/lists of numpy arrays."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.cpu().numpy()
    return conv(_to_tree(module))


def shapes(tree):
    """The nesting of ``tree`` with every array replaced by its shape."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shapes(v) for v in tree]
    return tuple(tree.shape)
