"""Collective traffic of a recorded call — the port of
``repro/roofline/hlo.py``, which parses post-partitioning HLO text.  The
port has no HLO: it reads ``stages.Compiled.as_text()``, one recorded op
a line (``analysis/tracekit.py``)::

    _c10d_functional.all_gather_into_tensor.default(float32[8, 16]) -> (float32[16, 16])

A sharded call is recorded for one rank, so a collective's RESULT shape is
the per-device buffer it moves, as in the reference: summing result bytes
gives per-device collective bytes, and the roofline's collective term is
bytes_per_device / link_bw.

The collectives map to the reference's kinds: ``all_gather_into_tensor``
and ``_allgather_base_`` to ``all-gather``, ``all_reduce`` and
``allreduce_`` to ``all-reduce``, ``reduce_scatter_tensor`` and
``_reduce_scatter_base_`` to ``reduce-scatter``, ``all_to_all_single`` to
``all-to-all``; any other op of the ``_c10d_functional`` / ``c10d``
namespaces counts under its own name.  ``wait_tensor`` and
``_wrap_tensor_autograd`` move nothing and do not count.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Tuple

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "bfloat16": 2, "float16": 2,
    "float32": 4, "float64": 8, "complex64": 8, "complex128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
KINDS = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")

# one recorded op:  namespace.op.overload(ins) -> (outs)
_LINE_RE = re.compile(r"^(\w+)\.(\w+)\.(\w+)\((.*)\) -> \((.*)\)$")
# one shape token: dtype[d0, d1, ...]
_SHAPE_RE = re.compile(r"\b([a-z]+\w*)\[([\d, ]*)\]")


def shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def parse_op(line: str):
    """``(namespace, op, ins, outs)`` of one recorded op line, each of
    ``ins`` / ``outs`` a list of ``(dtype, dims)``; None for another
    line."""
    m = _LINE_RE.match(line.strip())
    if not m:
        return None
    ns, op, _, ins, outs = m.groups()
    return ns, op, _SHAPE_RE.findall(ins), _SHAPE_RE.findall(outs)


def collective_kind(ns: str, op: str):
    """The reference's kind of a recorded op, or None for a non-collective
    op."""
    if ns not in _NAMESPACES or op in _NOT_COLLECTIVES:
        return None
    return KINDS.get(op, op)


def parse_hlo_collectives(text: str) -> Dict[str, Dict[str, int]]:
    """-> {op_kind: {"bytes": total_result_bytes, "count": n_ops}}."""
    out: Dict[str, Dict[str, int]] = defaultdict(
        lambda: dict(bytes=0, count=0))
    for line in text.splitlines():
        parsed = parse_op(line)
        if parsed is None:
            continue
        ns, op, _, outs = parsed
        kind = collective_kind(ns, op)
        if kind is None:
            continue
        out[kind]["bytes"] += sum(shape_bytes(d, dims) for d, dims in outs)
        out[kind]["count"] += 1
    return dict(out)


def collective_bytes_by_type(text: str) -> Tuple[int, Dict[str, int]]:
    parsed = parse_hlo_collectives(text)
    per_type = {k: v["bytes"] for k, v in parsed.items()}
    return sum(per_type.values()), per_type


def count_op(text: str, opcode: str) -> int:
    """Occurrences of a recorded op (``"mm"``, ``"transpose"``, ...) by its
    name without namespace or overload — used by the perf loop to spot
    recompute and layout copies."""
    return len(re.findall(rf"^\w+\.{re.escape(opcode)}\.\w+\(", text,
                          re.MULTILINE))
