"""Semirings for associative-array algebra (paper §II).

An associative array A: K1 x K2 -> V carries a commutative monoid (V, add, zero)
used to combine colliding entries on block update, plus a multiplicative op for
array-array contraction (A @ B).  The paper grounds SQL (union-intersection),
NoSQL and NewSQL table semantics in this algebra; we expose the standard set.

Only ``add``/``zero`` participate in the streaming-update hot path; ``mul``/
``one`` are used by the query-side contractions.

``segment_add`` reduces into an output filled with ``integer_zero`` through
``scatter_reduce(..., include_self=True)``, so an empty segment holds the
semiring zero (-inf / +inf, or the integer min / max) exactly as
``jax.ops.segment_max`` / ``segment_min`` leave it.  Ids outside
``[0, num_segments)`` are dropped, as ``jax.ops.segment_*`` drops them:
they are routed to a spare slot that is sliced off.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

_SCATTER_REDUCE = {"sum": "sum", "max": "amax", "min": "amin"}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (add, zero, mul, one) semiring over tensor values."""

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    zero: float
    mul: Callable[[Tensor, Tensor], Tensor]
    one: float

    def zeros(self, shape, dtype, device) -> Tensor:
        return torch.full(shape, integer_zero(self, dtype), dtype=dtype,
                          device=device)

    def segment_add(self, vals: Tensor, segment_ids: Tensor,
                    num_segments: int) -> Tensor:
        """Per-segment ``add`` reduction of a 1-D ``vals``; empty segments
        hold the semiring zero and ids outside ``[0, num_segments)`` are
        dropped (routed to a spare slot past the end)."""
        ids = segment_ids.long()
        ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                          num_segments)
        out = self.zeros((num_segments + 1,), vals.dtype, vals.device)
        out.scatter_reduce_(0, ids, vals, _SCATTER_REDUCE[reduce_kind(self)],
                            include_self=True)
        return out[:num_segments]


PLUS_TIMES = Semiring(name="plus.times", add=torch.add, zero=0.0,
                      mul=torch.mul, one=1.0)

# max.plus — tropical; value combine keeps the max (e.g. "latest timestamp").
MAX_PLUS = Semiring(name="max.plus", add=torch.maximum, zero=-math.inf,
                    mul=torch.add, one=0.0)

# min.plus — shortest-path style combine.
MIN_PLUS = Semiring(name="min.plus", add=torch.minimum, zero=math.inf,
                    mul=torch.add, one=0.0)

# max.min — bottleneck / fuzzy-logic semiring.
MAX_MIN = Semiring(name="max.min", add=torch.maximum, zero=-math.inf,
                   mul=torch.minimum, one=math.inf)


_BY_NAME = {s.name: s for s in (PLUS_TIMES, MAX_PLUS, MIN_PLUS, MAX_MIN)}


def get(name: str) -> Semiring:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown semiring {name!r}; available: {sorted(_BY_NAME)}")


def reduce_kind(sr: Semiring) -> str:
    """How ``sr.add`` reduces over an axis: "sum" | "max" | "min".

    The single source of truth for every add-reduction dispatch (segment
    reductions, axis reductions in the query engine).  Raises on an unknown
    semiring instead of silently picking a wrong reduction.
    """
    if sr.name == "plus.times":
        return "sum"
    if sr.name in ("max.plus", "max.min"):
        return "max"
    if sr.name == "min.plus":
        return "min"
    raise ValueError(f"no add-reduction known for semiring {sr.name!r}")


def integer_zero(sr: Semiring, dtype: torch.dtype):
    """Semiring zero clamped into an integer dtype's range (a Python
    number, usable as a ``torch.full`` / ``torch.where`` fill)."""
    z = sr.zero
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        if z == -math.inf:
            return info.min
        if z == math.inf:
            return info.max
        return int(z)
    return z
