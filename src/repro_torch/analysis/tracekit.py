"""tracekit — recorded-call audit and committed cost budgets for the fleet
entries (the counterpart of ``repro/analysis/tracekit.py``).

``repro_torch.analysis.lint`` checks the SOURCE; it cannot see what a
fleet entry does when it runs: a float64 tensor, a host read in the hot
path, a donated state that was copied after all.  Every production
dispatch of the port goes through ``repro_torch.stages``, and
``stages.fleet_jobs`` lists a config's whole dispatch set — ONE place
where all of it can be audited.  The port runs eagerly and has no jaxpr,
so an entry is audited by RECORDING it: one seeded call sequence of the
entry's function (``Wrapped.fn``, also for a ``"graph"`` entry, whose
replay launches are its ``Compiled.launches``) under a
``TorchDispatchMode`` that sees every aten op with its dtypes and shapes.

Run as::

    python -m repro_torch.analysis.tracekit --check     # tier-1 gate
    python -m repro_torch.analysis.tracekit --update    # regenerate budgets

**The call sequence** (``audit_fleet``), from ``numpy`` seed 0 on the
fleet's own shapes: the ingest entries (``stream.ingest_instances``,
``service.ingest``) take uniform random (row, col) keys in [0, 2**20)
with normal values, one round of ``[I, T, B]`` blocks a call, each call's
state fed to the next, until every layer of every instance has spilled
into the layer below it at least once (``spills[..., :L-1] > 0``) — so
every branch of the cut hierarchy (the layer-0 append, each spill depth)
runs in the record, where a single eager call would show only the branch
its data took; ``hier.update`` does the same on one instance, block by
block.  The query and read entries (``service.point_query``,
``query.engine.point_lookup``, ``service.analytics``, ``hier.query_all``,
``hier.flush``, ``hier.metrics_snapshot``) are recorded for one call on
the state the ingest sequence left (queries: half live keys of the
deepest layer, half random keys).

Rules (each guards a run-time invariant the source lint cannot see):

J001  A float64 or complex128 tensor in any op — a silent 2x bandwidth hit
      on every buffer it touches.
J002  A tensor above ``const_bytes`` reached from the wrapped function's
      closure, ``functools.partial`` arguments, defaults or the module
      globals its code names, rather than from its arguments: state
      belongs in arguments (a captured graph pins it; the cache key cannot
      see it).
J003  A ``donate_argnums`` position whose returned state shares no storage
      with the input: the entry declared it updates the state in place and
      copied it instead.
J004  A host read: ``.item()`` / ``int(t)`` / ``bool(t)`` / ``float(t)``
      (``aten._local_scalar_dense``), any op returning a Python scalar
      (``aten.equal``), ``Tensor.tolist`` and ``Tensor.numpy`` (which
      dispatch nothing, so the recorder wraps them while it records), and
      device-to-host copies.  Every host read of a production entry sits
      behind a per-entry allow with its reason; a ``"graph"`` entry gets
      none (a captured graph cannot read the host).
J005  An int64 tensor produced from integer inputs that are all 32-bit or
      narrower by a value op (a conversion, arithmetic, a bit op): the
      (hi, lo) pair discipline keeps keys int32.  The ops whose int64
      output is an index by torch's API (``sort``, ``topk``, ``nonzero``,
      ``argmax``, ``searchsorted``, ...) and torch's default promotion of
      integer reductions (``sum``, ``cumsum``, ``prod``) are not value
      widenings and do not count.
J006  One (entry, signature) lowered under more than ``retrace_limit``
      distinct argument signatures (``stages.lowered_keys``) in this
      process — shape polymorphism leaking through the signature.

**What the cost columns mean in the port** (per call, the mean over the
recorded sequence):

- ``flops`` and ``transcendentals``: every recorded op counted as XLA's
  ``HloCostAnalysis`` counts the reference's: the matrix-class ops (mm,
  bmm, addmm, convolution, attention) by the table
  ``torch.utils.flop_counter.FlopCounterMode`` counts by
  (``flop_registry``), every other op by ``op_cost``'s rules (elementwise
  work one flop an element, exp / log / tanh / rsqrt ... one
  transcendental an element, reductions, sorts, scatters; views, copies
  and gathers none), so elementwise, compare, softmax and optimizer work
  count, and the D4M entries' sorts, compares and bit ops too;
- ``bytes_accessed``: for every op that moves data, the bytes of its
  tensor inputs read once plus its tensor outputs written once (views and
  allocations move none), plus, on the card, the bytes each CUDA kernel
  wrapper reports through ``kernels/registry.py`` (``ctypes`` launches
  dispatch no aten op) — the count ``chip_smoke.merge_bound`` makes;
- ``peak_bytes``: on the CPU (and on ``meta``) the high-water mark of
  the bytes the call's ops allocate, tracked by the recorder (an output
  counts until its tensor is freed); on the card the rise of
  ``torch.cuda.max_memory_allocated`` over the call.

**A sharded call is counted for one rank.**  An op on DTensors is not
recorded as such (its shapes are global): the recorder lets DTensor's own
dispatch run it, and records the rank's local ops that come back, with
their local shapes, and the collectives between them — the functional
ones DTensor calls (``_c10d_functional.all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, each
with its per-device result) and the ``torch.distributed`` ones the fleet
calls (``c10d.allreduce_``, ...).  The ops DTensor's sharding propagation
runs on fake tensors at the global shape, or on ``meta`` tensors through
an op's decomposition on a cache miss, are neither recorded nor counted
in ``flops``.  Bytes count local shards, and a tensor's storage is told
apart by its identity, not by its data pointer (0 for every ``meta``
tensor), so a call on ``meta`` tensors — a dry run of a full-size
configuration — counts its arguments and its peak by their shapes.  A
call turns sharded at its first op on DTensors; a call on plain tensors
never does, and is recorded with no propagation filter.

Suppression: allows are PER ENTRY —

    # tracekit: allow(J004) entry=service.ingest <reason>

on any line of the audited source tree (``--src``, default
``src/repro_torch``); the entry field is an ``fnmatch`` glob and the
reason is mandatory.  A J005 hit has a source site (the port function
that widened), so a J005 allow excuses only the widenings made in its own
file: ``entry=*`` at ``assoc.pack_key`` does not excuse a new widening
elsewhere.  Accepted debt can also live in the committed
baseline (``tracekit_baseline.txt``, the ``analysis.baseline`` machinery
— it starts and stays empty).

Cost budgets: ``--update`` records every entry's ``flops`` /
``bytes_accessed`` / ``peak_bytes`` into the committed
``analysis/COST_BUDGETS.json``; ``--check`` fails when an entry exceeds
its budget by more than ``--tolerance`` (default 10 %) or has no budget.
The committed budgets are recorded on the CPU at the smoke config, and
the CLI records on the CPU; ``chip_smoke.py`` phase 16 records the
production config on the card through ``audit_fleet(cfg,
device="cuda")``, where the rules gate and the budgets are printed for
comparison only.  The fleet across ranks (``mesh=``) is not recorded
here: phase 12 holds it to the single-process answers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import fnmatch
import functools
import gc
import hashlib
import json
import math
import os
import re
import sys
import time
import traceback
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Set, Tuple

from repro_torch.analysis import baseline as _baseline

RULES = {
    "J001": "float64/complex128 tensor in a recorded op (x64 leak)",
    "J002": "oversized tensor held by the entry's closure",
    "J003": "declared donation not honored (no storage shared)",
    "J004": "host read reachable from a production entry",
    "J005": "int64 value widened from <=32-bit integer inputs",
    "J006": "entry lowered under too many distinct argument signatures",
}

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
DEFAULT_BASELINE = os.path.join(_HERE, "tracekit_baseline.txt")
DEFAULT_BUDGETS = os.path.join(_HERE, "COST_BUDGETS.json")
DEFAULT_SRC = os.path.join(_ROOT, "src", "repro_torch")
DEFAULT_TOLERANCE = 0.10

_ALLOW_RE = re.compile(
    r"#\s*tracekit:\s*allow\(([A-Za-z0-9, ]+)\)\s+entry=(\S+)\s*(.*)$")

# aten ops whose int64 output is an index or a count by torch's API, not a
# widened value (J005)
_INDEX_OPS = {"sort", "argsort", "topk", "kthvalue", "mode", "max", "min",
              "argmax", "argmin", "nonzero", "nonzero_static",
              "searchsorted", "bucketize", "unique_consecutive",
              "_unique2", "unique_dim", "cummax", "cummin", "sum",
              "cumsum", "prod", "cumprod", "count_nonzero", "histc",
              "bincount", "arange", "_local_scalar_dense"}
# ops that move no bytes: allocations and aliasing (bytes_accessed)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "resize_", "set_", "_local_scalar_dense",
               "wait_tensor", "_wrap_tensor_autograd"}
_WIDE = {"float64", "complex128"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    entry: str
    detail: str          # stable scope token — the baseline identity
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule} {self.entry} {self.detail}"

    def render(self) -> str:
        return f"{self.entry}: {self.rule} {self.message}"


@dataclasses.dataclass
class AuditConfig:
    """Rule thresholds.  ``const_bytes``: J002 fires above this many bytes
    in one closure-held tensor.  ``retrace_limit``: J006 fires when one
    (entry, signature) has been lowered under MORE than this many distinct
    argument signatures."""
    const_bytes: int = 1 << 20
    retrace_limit: int = 4


# -------------------------------------------------------------- recorder ---


@dataclasses.dataclass
class OpEvent:
    """One recorded aten op: its name, input and output (dtype, shape)
    pairs and the bytes it moved."""
    name: str
    ins: Tuple[Tuple[str, Tuple[int, ...]], ...]
    outs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    nbytes: int


@dataclasses.dataclass
class Trace:
    """What one recorded call sequence did: every op, every host read
    (kind, site), every kernel launch a wrapper reported (name, bytes),
    the flops and transcendentals, and per call the peak bytes."""
    ops: List[OpEvent] = dataclasses.field(default_factory=list)
    host_reads: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    kernels: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    widenings: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    flops: int = 0
    transcendentals: int = 0
    calls: int = 0
    peaks: List[int] = dataclasses.field(default_factory=list)
    arg_bytes: int = 0
    out_bytes: int = 0
    alias_bytes: int = 0

    @property
    def bytes_accessed(self) -> int:
        return sum(o.nbytes for o in self.ops) + sum(b for _, b in
                                                     self.kernels)

    def per_call(self) -> dict:
        n = max(self.calls, 1)
        return dict(flops=self.flops / n,
                    transcendentals=self.transcendentals / n,
                    bytes_accessed=self.bytes_accessed / n,
                    peak_bytes=max(self.peaks) if self.peaks else 0,
                    host_reads=len(self.host_reads) / n,
                    launches=len(self.kernels) / n)

    def cost_dict(self) -> dict:
        """The reference's ``cost_analysis()`` keys, per call."""
        pc = self.per_call()
        return {"flops": pc["flops"],
                "transcendentals": pc["transcendentals"],
                "bytes accessed": pc["bytes_accessed"],
                "peak bytes": pc["peak_bytes"]}

    def as_text(self) -> str:
        lines = []
        for o in self.ops:
            ins = ", ".join(f"{d}{list(s)}" for d, s in o.ins)
            outs = ", ".join(f"{d}{list(s)}" for d, s in o.outs)
            lines.append(f"{o.name}({ins}) -> ({outs})")
        lines += [f"kernel {n} bytes={b}" for n, b in self.kernels]
        lines += [f"host_read {k} at {s}" for k, s in self.host_reads]
        return "\n".join(lines)


def _leaves(x) -> list:
    import torch
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, torch.nn.Module):     # a model's ParamTree
            out.extend(v.parameters())
            out.extend(v.buffers())
        elif isinstance(v, (list, tuple)):
            for c in v:
                walk(c)
        elif isinstance(v, dict):
            for c in v.values():
                walk(c)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
    walk(x)
    return out


_DTENSOR = None     # DTensor's class, imported by the first recording


def _local(t):
    """A DTensor's local shard (this rank's tensor); ``t`` otherwise."""
    if _DTENSOR is not None and isinstance(t, _DTENSOR):
        return t._local_tensor
    return t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _storage_id(t) -> int:
    """The identity of a tensor's (local) storage: its address in memory,
    not its data pointer, which is 0 for every ``meta`` tensor."""
    return _local(t).untyped_storage()._cdata


_PROPAGATION = ("tensor/_sharding_prop.py", "tensor/_decompositions.py")


def _in_propagation(depth: int = 10) -> bool:
    """True inside DTensor's sharding propagation, which on a cache miss
    runs some ops (a decomposition's) on ``meta`` tensors of the global
    shape: they are not the rank's work.  The propagation calls the op a
    few frames above the recorder's mode, so ``depth`` frames are
    looked at."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.replace(os.sep, "/").endswith(_PROPAGATION):
            return True
        f, depth = f.f_back, depth - 1
    return False


def _op_leaves(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, a kwargs dict), appended to ``out``."""
    import torch
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _op_leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _op_leaves(v, out)
    return out


def _is_fake(leaves) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in leaves)


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _site(function: bool = False) -> str:
    """The innermost frame of the port outside the analysis package and
    ``stages.py`` — where a host read or a widening was made — as
    ``file:line``, or with ``function`` the line-free ``file:function``."""
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace(os.sep, "/")
        if "/repro_torch/" in path and "/analysis/" not in path \
                and not path.endswith("/stages.py"):
            where = path.split("/repro_torch/", 1)[1]
            return f"{where}:{fr.name if function else fr.lineno}"
    return "?"


# -------------------------------------------------------------- op costs ---
#
# The flops and transcendentals of one aten op outside
# ``FlopCounterMode``'s table (``Recorder.on_op`` asks the table first),
# by the rules XLA's ``HloCostAnalysis`` applies to the reference's ops,
# as ``jax.jit(f).lower(...).compile().cost_analysis()`` gives them on the
# JAX CPU backend.  Each rule reads shapes, dtypes and scalar arguments
# only, so it counts the same on ``meta`` tensors and on a DTensor's local
# ops.  N is the op's output elements unless a rule says otherwise.
#
# - elementwise arithmetic, compare, logical, bitwise, shift, select
#   (``where``, ``masked_fill``), clamp, ``relu``, ``maximum`` /
#   ``minimum``: N flops; a dtype conversion (``_to_copy`` or ``copy_``
#   between dtypes) N, a copy within one dtype 0;
# - transcendentals (exp, expm1, log, log1p, tanh, rsqrt, sqrt, erf, sin,
#   cos): N under ``"transcendentals"`` and no flop; ``pow`` by an
#   integral scalar is XLA's ``integer_pow``, its multiplies (x**2: N,
#   x**3 and x**4: 2N), by anything else a transcendental;
# - composites, per output element as XLA counts their expansion:
#   ``_COMPOSITE`` (sigmoid 3 flops + 1 transcendental, silu 4 + 1, ...;
#   a backward op as the reference's vjp less its forward); the row-wise
#   softmax, log-softmax and logsumexp by formula over N inputs and R rows;
# - reductions (sum, mean, amax, amin, prod, any, all, full max / min):
#   input elements - output elements, and ``mean`` N more (its divide);
#   ``var`` 4 x input elements; argmax / argmin and max / min along a dim
#   (XLA's variadic value-index reduce) 9 x (input - output);
# - sort, argsort and topk: n x ceil(log2 n) over the operand's n elements,
#   whatever the sorted dimension ([4096] -> 49,152; [8, 1024] ->
#   106,496).  XLA's CPU backend lowers an integer ``lax.top_k`` to that
#   sort and a float one to a custom call it counts as -1 flop: the rule
#   is the sort's for both;
# - scatter-adds and scatter-reduces (``index_add``, ``scatter_add``,
#   ``scatter_reduce``, ``index_put`` with ``accumulate``, ``bincount``):
#   1 per update element;
# - scans (cumsum, cumprod, cummax, cummin): N (one combine an element;
#   XLA's CPU lowering is a reduce-window, [4096] -> 69,887);
#   ``searchsorted``: Q x ceil(log2(n + 1)) compares for Q queries into n
#   sorted entries (the reference's binary searches are ``while`` loops
#   whose body XLA counts once);
# - every other op 0: views, copies, gathers (``index``,
#   ``index_select``, ``gather``), ``cat``, ``stack``, pads, fills,
#   allocations, collectives.  A CUDA kernel's launch through
#   ``kernels/registry.py`` dispatches no aten op and counts 0, as XLA
#   counts the reference's ``pallas_call``s (no ``cost_estimate``).
#
# Where jnp decomposes one call into several HLO ops (a negative-index
# clamp in front of every gather and scatter, the sign fixes of integer
# floor division) the reference counts more than the port's one op.

_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn",
    "floor", "ceil", "round", "trunc", "frac", "remainder", "fmod",
    "reciprocal", "square", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "where", "masked_fill", "clamp", "clamp_min",
    "clamp_max", "relu", "maximum", "minimum", "fmax", "fmin", "isnan",
    "copysign"))
_TRANSCENDENTAL = frozenset((
    "exp", "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt", "erf", "sin",
    "cos"))
# (flops, transcendentals) per output element
_COMPOSITE = {
    "sigmoid": (3, 1), "silu": (4, 1), "elu": (3, 1), "leaky_relu": (3, 0),
    "threshold_backward": (1, 0), "sigmoid_backward": (3, 0),
    "silu_backward": (5, 0), "elu_backward": (5, 0),
    "leaky_relu_backward": (2, 0), "_softmax_backward_data": (5, 0),
    "_log_softmax_backward_data": (1, 0)}
_REDUCTIONS = frozenset(("sum", "nansum", "mean", "prod", "amax", "amin",
                         "any", "all", "max", "min"))
_VARIADIC_REDUCTIONS = frozenset(("argmax", "argmin"))
_SORTS = frozenset(("sort", "argsort", "msort", "topk"))
_SCANS = frozenset(("cumsum", "cumprod", "cummax", "cummin"))
# scatter -> the position of the argument whose elements are the updates
_SCATTERS = {"index_add": 3, "scatter_add": 2, "scatter_reduce": 2,
             "bincount": 0}


def _log2_ceil(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def _integer_pow(exponent) -> Optional[int]:
    """Multiplies per element of XLA's ``integer_pow`` (square and
    multiply; a divide more for a negative exponent), or None when the
    exponent is not an integral scalar."""
    if isinstance(exponent, bool) or not isinstance(exponent, (int, float)) \
            or not math.isfinite(exponent) or exponent != int(exponent):
        return None
    n = abs(int(exponent))
    if n == 0:
        return 0
    return n.bit_length() + bin(n).count("1") - 2 + (exponent < 0)


def _updates(name: str, args) -> int:
    """Update elements of a scatter (``index_put``: the elements its
    integer indices select)."""
    if name in ("index_put", "_index_put_impl"):
        import torch
        idx = [i for i in args[1] if i is not None]
        if any(i.dtype == torch.bool for i in idx):
            return args[2].numel()
        n = math.prod(torch.broadcast_shapes(*(i.shape for i in idx)))
        return n * math.prod(args[0].shape[len(args[1]):])
    return args[_SCATTERS[name]].numel()


def op_cost(func, args, kwargs, ins, outs) -> Tuple[int, int]:
    """``(flops, transcendentals)`` of one aten op outside
    ``FlopCounterMode``'s table, by the rules above."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                 # the in-place form counts the same
    if not outs or not ins:
        return 0, 0
    n = outs[0].numel()
    if name in _ELEMENTWISE:
        return n, 0
    if name in _TRANSCENDENTAL:
        return 0, n
    if name in _COMPOSITE:
        f, t = _COMPOSITE[name]
        return f * n, t * n
    if name == "pow":
        mults = _integer_pow(args[1]) \
            if func._overloadname == "Tensor_Scalar" else None
        return (0, n) if mults is None else (mults * n, 0)
    if name in ("_to_copy", "copy"):
        return (n, 0) if ins[-1].dtype != outs[0].dtype else (0, 0)
    m = ins[0].numel()
    if name in ("_softmax", "_log_softmax", "logsumexp"):
        if name == "logsumexp":
            rows = n
        else:
            size = ins[0].shape[args[1]] if ins[0].dim() else 1
            rows = m // size if size else 0
        if name == "_softmax":
            return 2 * (m - rows) + 2 * m, m
        if name == "_log_softmax":
            return 2 * (m - rows) + 3 * m, m + rows
        return 2 * (m - rows) + m + 4 * rows, m + rows
    if name in ("max", "min") and func._overloadname == "other":
        return n, 0                      # the binary max: elementwise
    if name in _VARIADIC_REDUCTIONS or (
            name in ("max", "min") and func._overloadname == "dim"):
        return 9 * (m - n), 0
    if name in _REDUCTIONS:
        return m - n + (n if name == "mean" else 0), 0
    if name == "var":
        return 4 * m, 0
    if name in _SORTS:
        return m * _log2_ceil(m), 0
    if name in _SCANS:
        return n, 0
    if name in _SCATTERS or (name in ("index_put", "_index_put_impl") and (
            args[3] if len(args) > 3 else kwargs.get("accumulate", False))):
        return _updates(name, args), 0
    if name == "searchsorted":
        return n * _log2_ceil(args[0].shape[-1] + 1), 0
    return 0, 0


class Recorder:
    """Records every aten op of the calls run inside ``active()``: a
    ``TorchDispatchMode`` for the ops, wrappers around ``Tensor.tolist`` /
    ``Tensor.numpy`` for the host reads that dispatch nothing, the kernel
    registry's bytes hook for the CUDA launches, ``FlopCounterMode``'s
    table and ``op_cost`` for flops and transcendentals, and the peak bytes
    per call.  ``paused()`` excludes harness work (moving data, reading
    spills) from the record."""

    def __init__(self):
        self.trace = Trace()
        self._paused = 0
        self._in_host_call = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._peak = 0
        self._sharded = False       # the call has run an op on DTensors
        self._flop_table = {}

    # ---------------------------------------------------------- plumbing --
    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _note_host(self, kind: str) -> None:
        if not self._paused:
            self.trace.host_reads.append((kind, _site()))

    def _note_kernel(self, name: str, nbytes: int) -> None:
        if not self._paused:
            self.trace.kernels.append((name, int(nbytes)))

    def _alloc(self, t) -> None:
        key = id(t)
        if key in self._live:
            return
        n = _nbytes(t)
        self._live[key] = n
        self._live_bytes += n
        self._peak = max(self._peak, self._live_bytes)
        weakref.finalize(t, self._free, key)

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def on_op(self, func, args, kwargs, out, ins, outs) -> None:
        """Record one op (``ins`` / ``outs``: the tensors of its arguments
        and results) and count its flops: ``FlopCounterMode``'s table for
        the matrix-class ops (``mm``, ``bmm``, ``addmm``, convolutions,
        attention, ...), ``op_cost``'s rules for every other op."""
        import torch
        if self._paused:
            return
        name = func.overloadpacket.__name__
        count = self._flop_table.get(func._overloadpacket)
        if count is not None:
            self.trace.flops += int(count(*args, **kwargs, out_val=out))
        else:
            flops, trans = op_cost(func, args, kwargs, ins, outs)
            self.trace.flops += flops
            self.trace.transcendentals += trans
        scalar_out = not outs and isinstance(out, (bool, int, float)) \
            and bool(ins)
        if (scalar_out or name == "_local_scalar_dense") \
                and not self._in_host_call:
            self._note_host("item" if name == "_local_scalar_dense"
                            else name)
        if name in ("_to_copy", "copy_", "to") and not self._in_host_call:
            src = [t for t in ins if t.device.type != "cpu"]
            dst = [t for t in outs if t.device.type == "cpu"]
            if src and dst:
                self._note_host("d2h")
        if name not in _INDEX_OPS and any(
                d == "int64" for d in map(_dtype_name, outs)):
            ints = [_dtype_name(t) for t in ins
                    if not t.dtype.is_floating_point
                    and not t.dtype.is_complex and t.dtype != torch.bool]
            if ints and not any(d in ("int64", "uint64") for d in ints):
                self.trace.widenings.append((str(func), _site(True)))
        moves = not (getattr(func, "is_view", False) or name in _NO_TRAFFIC)
        nbytes = (sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in outs)) if moves else 0
        self.trace.ops.append(OpEvent(
            name=str(func),
            ins=tuple((_dtype_name(t), tuple(t.shape)) for t in ins),
            outs=tuple((_dtype_name(t), tuple(t.shape)) for t in outs),
            nbytes=nbytes))
        if moves and not name.endswith("_") and name != "copy_":
            for t in outs:
                if isinstance(t, torch.Tensor) \
                        and t.device.type in ("cpu", "meta"):
                    self._alloc(t)

    # ------------------------------------------------------------ record --
    @contextlib.contextmanager
    def active(self, device=None):
        """Record the ops run inside; one ``active()`` is one call.  The
        call turns sharded at its first op on DTensors: from then on the
        sharding propagation's ops are told apart and left out."""
        import torch
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels import registry
        rec = self
        self._flop_table = flop_registry
        global _DTENSOR
        _DTENSOR = DTensor

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if DTensor in types:
                    # DTensor's dispatch runs the op; its local ops and
                    # collectives come back here
                    rec._sharded = True
                    return NotImplemented
                kwargs = kwargs or {}
                ins = _op_leaves(kwargs, _op_leaves(args, []))
                if rec._sharded and (_is_fake(ins) or _in_propagation()):
                    return func(*args, **kwargs)     # sharding propagation
                out = func(*args, **kwargs)
                outs = _op_leaves(out, [])
                if not (rec._sharded and _is_fake(outs)):
                    rec.on_op(func, args, kwargs, out, ins, outs)
                return out

        def host_method(name, orig):
            @functools.wraps(orig)
            def read(t, *a, **k):
                if not (rec._sharded and _in_propagation()):
                    rec._note_host(name)
                rec._in_host_call += 1
                try:
                    return orig(t, *a, **k)
                finally:
                    rec._in_host_call -= 1
            return read

        saved = {m: getattr(torch.Tensor, m) for m in ("tolist", "numpy")}
        cuda = device is not None and torch.device(device).type == "cuda"
        gc.collect()        # no earlier garbage freed inside the call
        if cuda:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        self._peak = self._live_bytes = 0
        self._live.clear()
        self._sharded = False
        prev_hook = registry.BYTES_HOOK
        registry.BYTES_HOOK = self._note_kernel
        try:
            for m, orig in saved.items():
                setattr(torch.Tensor, m, host_method(m, orig))
            with _Mode():
                yield self
        finally:
            for m, orig in saved.items():
                setattr(torch.Tensor, m, orig)
            registry.BYTES_HOOK = prev_hook
        self.trace.calls += 1
        if cuda:
            torch.cuda.synchronize(device)
            self.trace.peaks.append(
                max(torch.cuda.max_memory_allocated(device) - base, 0))
        else:
            self.trace.peaks.append(self._peak)


# ---------------------------------------------------------------- records --


def _clone_tree(x):
    """``x`` with every tensor leaf cloned (an in-place entry then moves
    the clones, never the caller's state)."""
    import copy

    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.nn.Module):          # a model's ParamTree
        return copy.deepcopy(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(c) for c in x)
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _device_of(args):
    leaves = _leaves(args)
    return leaves[0].device if leaves else None


class AuditRecord:
    """One audited entry: the ``Wrapped``, the arguments of its first
    call, and the recorded sequence (``drive(call)`` makes the calls; by
    default one call on ``args``)."""

    def __init__(self, entry: str, wrapped, args: tuple,
                 drive: Optional[Callable] = None):
        self.entry = entry
        self.wrapped = wrapped
        self.args = tuple(args)
        self.sig = wrapped.sig
        self.key = wrapped._key(self.args)
        self._drive = drive
        self._trace: Optional[Trace] = None
        self.donation_kept: List[bool] = []
        self.outputs = None

    @property
    def donate_argnums(self) -> Tuple[int, ...]:
        return tuple(dict(self.wrapped.options).get("donate_argnums", ()))

    @property
    def trace(self) -> Trace:
        if self._trace is None:
            self._record()
        return self._trace

    def _record(self) -> None:
        from repro_torch import stages
        comp = stages.compiled_for(self.wrapped, *self.args)
        rec = Recorder()
        device = _device_of(self.args)
        donated = self.donate_argnums

        def call(*args):
            with rec.active(device):
                out = self.wrapped.fn(*args)
            with rec.paused():
                if donated:
                    ins = {t.untyped_storage().data_ptr()
                           for p in donated if p < len(args)
                           for t in _leaves(args[p])}
                    self.donation_kept.append(any(
                        t.untyped_storage().data_ptr() in ins
                        for t in _leaves(out)))
            self.outputs = out
            return out

        if self._drive is None:
            call(*self.args)
        else:
            self._drive(call, rec)
        self._trace = rec.trace
        comp.recorded = rec.trace
        _note_memory(rec.trace, self.args, self.outputs)


def _note_memory(t: Trace, args, out) -> None:
    """Argument, output and aliased bytes of a recorded call (by storage,
    each counted once; a DTensor by its local shard) —
    ``Compiled.memory_analysis``'s fields."""
    arg = {_storage_id(x): _nbytes(x) for x in _leaves(args)}
    outs = {_storage_id(x): _nbytes(x) for x in _leaves(out)}
    t.arg_bytes, t.out_bytes = sum(arg.values()), sum(outs.values())
    t.alias_bytes = sum(n for p, n in outs.items() if p in arg)


def record(wrapped, *args, entry: Optional[str] = None,
           drive: Optional[Callable] = None) -> AuditRecord:
    """An audit record of one staged entry (fixture tests drive the rules
    through this without a fleet)."""
    return AuditRecord(entry or wrapped.entry, wrapped, tuple(args), drive)


def record_compiled(comp, args) -> Trace:
    """Record one call of a ``stages.Compiled``'s function on clones of
    ``args``; the trace is kept on ``comp.recorded`` (the source of its
    ``cost_analysis`` / ``as_text`` / ``memory_analysis``)."""
    args = _clone_tree(tuple(args))
    rec = Recorder()
    with rec.active(_device_of(args)):
        out = comp.fn(*args)
    _note_memory(rec.trace, args, out)
    comp.recorded = rec.trace
    return rec.trace


# ------------------------------------------------------------------ rules ---


def _j001(rec: AuditRecord, cfg: AuditConfig) -> Iterable[Violation]:
    hits: Dict[str, str] = {}
    for op in rec.trace.ops:
        for d, _ in op.ins + op.outs:
            if d in _WIDE:
                hits.setdefault(d, op.name)
    for name, where in sorted(hits.items()):
        yield Violation(
            "J001", rec.entry, name,
            f"{name} tensor (first at '{where}') in the recorded calls — "
            "a silent 2x bandwidth hit or a truncation waiting at the "
            "boundary")


def _closure_tensors(fn, seen: Set[int], depth: int = 0) -> Iterable:
    """(path, tensor) for every tensor reached from ``fn``'s closure
    cells, ``functools.partial`` arguments and defaults."""
    import torch
    if depth > 6 or id(fn) in seen:
        return
    seen.add(id(fn))

    def walk(v, path, d):
        if d > 6 or id(v) in seen:
            return
        if isinstance(v, torch.Tensor):
            yield path, v
            return
        seen.add(id(v))
        if isinstance(v, torch.nn.Module):
            for n, p in v.named_parameters():
                yield f"{path}.{n}", p
            for n, b in v.named_buffers():
                yield f"{path}.{n}", b
        elif isinstance(v, (list, tuple)):
            for i, c in enumerate(v):
                yield from walk(c, f"{path}[{i}]", d + 1)
        elif isinstance(v, dict):
            for k, c in v.items():
                yield from walk(c, f"{path}[{k!r}]", d + 1)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                yield from walk(getattr(v, f.name), f"{path}.{f.name}",
                                d + 1)
        elif callable(v):
            yield from _closure_tensors(v, seen, d + 1)

    if isinstance(fn, functools.partial):
        yield from walk(fn.func, "partial.func", depth)
        for i, a in enumerate(fn.args):
            yield from walk(a, f"partial.args[{i}]", depth)
        for k, a in (fn.keywords or {}).items():
            yield from walk(a, f"partial.{k}", depth)
        return
    code = getattr(fn, "__code__", None)
    for name, cell in zip(getattr(code, "co_freevars", ()),
                          getattr(fn, "__closure__", None) or ()):
        try:
            val = cell.cell_contents
        except ValueError:
            continue
        yield from walk(val, name, depth)
    glob = getattr(fn, "__globals__", {})
    for name in getattr(code, "co_names", ()):
        val = glob.get(name)
        if isinstance(val, (torch.Tensor, torch.nn.Module, list, tuple,
                            dict)):
            yield from walk(val, f"global {name}", depth)
    for i, a in enumerate(getattr(fn, "__defaults__", None) or ()):
        yield from walk(a, f"default[{i}]", depth)
    for k, a in (getattr(fn, "__kwdefaults__", None) or {}).items():
        yield from walk(a, f"default.{k}", depth)


def _j002(rec: AuditRecord, cfg: AuditConfig) -> Iterable[Violation]:
    seen_detail: Set[str] = set()
    for path, t in _closure_tensors(rec.wrapped.fn, set()):
        n = _nbytes(t)
        if n <= cfg.const_bytes:
            continue
        shape = "x".join(map(str, t.shape))
        detail = f"closure[{shape}:{_dtype_name(t)}]"
        if detail in seen_detail:
            continue
        seen_detail.add(detail)
        yield Violation(
            "J002", rec.entry, detail,
            f"tensor {shape}:{_dtype_name(t)} ({n} bytes > "
            f"{cfg.const_bytes}) held by the entry's closure at '{path}' "
            "— state belongs in arguments (a captured graph pins it and "
            "the cache key cannot see it)")


def _j003(rec: AuditRecord, cfg: AuditConfig) -> Iterable[Violation]:
    if not rec.donate_argnums:
        return
    rec.trace
    if rec.donation_kept and not all(rec.donation_kept):
        yield Violation(
            "J003", rec.entry, "donation",
            f"donate_argnums={rec.donate_argnums} declared but the "
            "returned state shares no storage with the donated input — "
            "the state was copied, not updated in place")


def _j004(rec: AuditRecord, cfg: AuditConfig) -> Iterable[Violation]:
    first: Dict[str, str] = {}
    count: Dict[str, int] = {}
    for kind, site in rec.trace.host_reads:
        first.setdefault(kind, site)
        count[kind] = count.get(kind, 0) + 1
    for kind in sorted(first):
        yield Violation(
            "J004", rec.entry, kind,
            f"host read '{kind}' ({count[kind]} in {rec.trace.calls} "
            f"call(s), first at {first[kind]}) — a device->host sync on "
            "the production path")


def _j005(rec: AuditRecord, cfg: AuditConfig) -> Iterable[Violation]:
    seen: Set[str] = set()
    for op, site in rec.trace.widenings:
        detail = f"widen:{op}@{site}"
        if detail in seen:
            continue
        seen.add(detail)
        yield Violation(
            "J005", rec.entry, detail,
            f"'{op}' at {site} widens <=32-bit integer inputs to int64 — "
            "(hi, lo) pair compares stay int32 (core/assoc.py "
            "CONTRACTS); packing into int64 doubles key bandwidth")


def _j006(records: Sequence[AuditRecord], cfg: AuditConfig,
          lowered_keys: Sequence) -> Iterable[Violation]:
    """A process-level rule: it counts every lowering the stages cache
    has seen for the audited (entry, signature) pairs."""
    audited = {(r.key[0], r.key[1]): r.entry for r in records}
    per: Dict[Tuple, Set] = {}
    for key in lowered_keys:
        ident = (key[0], key[1])
        if ident in audited:
            per.setdefault(ident, set()).add((key[4], key[5]))
    for ident, sigs in sorted(per.items(), key=lambda kv: audited[kv[0]]):
        if len(sigs) > cfg.retrace_limit:
            yield Violation(
                "J006", audited[ident], "retrace",
                f"lowered under {len(sigs)} distinct argument signatures "
                f"(limit {cfg.retrace_limit}) in one process — shape "
                "polymorphism is leaking through the signature; each "
                "leak is a separate cache entry (and capture)")


_RECORD_RULES = (_j001, _j002, _j003, _j004, _j005)


def run_rules(records: Sequence[AuditRecord],
              cfg: Optional[AuditConfig] = None,
              lowered_keys: Optional[Sequence] = None) -> List[Violation]:
    """All J-rule violations over ``records`` (unsuppressed view — allows
    and baseline are applied by the caller/CLI)."""
    cfg = cfg or AuditConfig()
    out: List[Violation] = []
    for rec in records:
        for rule in _RECORD_RULES:
            out.extend(rule(rec, cfg))
    if lowered_keys is None:
        from repro_torch import stages
        lowered_keys = stages.lowered_keys()
    out.extend(_j006(records, cfg, lowered_keys))
    return sorted(out, key=lambda v: (v.entry, v.rule, v.detail))


# ----------------------------------------------------------- suppression ----


def _scan(paths: Sequence[str]) -> List[Tuple[Set[str], str, str, str]]:
    from repro_torch.analysis.lint import iter_py_files
    out = []
    for path in iter_py_files(paths):
        where = os.path.abspath(path).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                m = _ALLOW_RE.search(line)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
                    out.append((rules, m.group(2), m.group(3).strip(),
                                where))
    return out


def scan_allows(paths: Sequence[str]) -> List[Tuple[Set[str], str, str]]:
    """Collect ``# tracekit: allow(J00x) entry=<glob> <reason>`` comments
    from the source tree; a missing reason does not suppress."""
    return [a[:3] for a in _scan(paths)]


def suppressed(v: Violation,
               allows: Sequence[Tuple[Set[str], str, str]]) -> bool:
    return any(v.rule in rules and reason
               and fnmatch.fnmatchcase(v.entry, glob)
               for rules, glob, reason in allows)


def _site_file(v: Violation) -> Optional[str]:
    """The source file of a J005 hit (``widen:<op>@<file>:<function>``)."""
    if v.rule != "J005" or "@" not in v.detail:
        return None
    return v.detail.rsplit("@", 1)[1].rsplit(":", 1)[0]


def _suppressed_in_tree(v: Violation, allows) -> bool:
    """``suppressed`` over allows that carry their file: a J005 allow
    counts only in the file of the hit's site."""
    site = _site_file(v)
    return suppressed(v, [a[:3] for a in allows
                          if site is None or a[3].endswith("/" + site)])


# ---------------------------------------------------------------- budgets ---

_BUDGET_FIELDS = ("flops", "bytes_accessed", "peak_bytes")


def _sig_digest(rec: AuditRecord) -> str:
    # the torch version is left out (unlike stages' span digest): a
    # toolchain bump shows up as a budget DIFF, not an orphaned budget
    text = "|".join([repr(rec.sig), str(rec.key[2]), str(rec.key[3]),
                     str(rec.key[4]), repr(rec.key[5])])
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _sig_summary(sig) -> str:
    parts = []
    for f in dataclasses.fields(sig):
        v = getattr(sig, f.name)
        if v not in (None, (), False) and not (f.name == "dtype"
                                               and v == "float32") \
                and not (f.name == "sr" and v == "plus.times") \
                and not (f.name == "chunk" and v == 1) \
                and not (f.name == "fused" and v is True):
            parts.append(f"{f.name}={v}")
    return " ".join(parts) or "<default>"


def measure(records: Sequence[AuditRecord]) -> Dict[str, dict]:
    """Per-(entry, signature) cost rows keyed ``"<entry> <digest>"``:
    the budget fields per call, and the calls, host reads and launches a
    call of the recorded sequence."""
    out: Dict[str, dict] = {}
    for rec in records:
        pc = rec.trace.per_call()
        out[f"{rec.entry} {_sig_digest(rec)}"] = dict(
            entry=rec.entry, signature=_sig_summary(rec.sig),
            flops=pc["flops"], bytes_accessed=pc["bytes_accessed"],
            peak_bytes=pc["peak_bytes"], calls=rec.trace.calls,
            host_reads_per_call=pc["host_reads"],
            launches_per_call=pc["launches"])
    return out


def load_budgets(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_budgets(path: str, measured: Dict[str, dict],
                  tolerance: float, *, config: str = "smoke") -> None:
    import torch
    payload = {
        "_meta": dict(
            tolerance=tolerance,
            generated=time.strftime("%Y-%m-%dT%H:%M:%S"),
            torch=torch.__version__, backend="cpu", config=config,
            command="python -m repro_torch.analysis.tracekit --update",
            note="committed per-(entry, signature) cost budgets, per call "
                 "of the recorded sequence — --check fails when an entry "
                 "exceeds its budget by more than the tolerance",
        ),
        "entries": {k: measured[k] for k in sorted(measured)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")


def compare_budgets(measured: Dict[str, dict], budgets: dict,
                    tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Budget-vs-actual diff: ``breaches`` (actual > budget * (1+tol)),
    ``missing`` (dispatched but unbudgeted — a new entry must be
    committed via --update), ``stale`` (budgeted but not dispatched),
    ``improved`` (actual < budget / (1+tol) — candidates to ratchet
    down), and the full ``rows`` table."""
    entries = budgets.get("entries", {})
    breaches, missing, improved, rows = [], [], [], []
    for key, act in sorted(measured.items()):
        bud = entries.get(key)
        if bud is None:
            missing.append(key)
            rows.append((key, None, act, "MISSING"))
            continue
        verdict = "ok"
        for field in _BUDGET_FIELDS:
            b, a = bud.get(field), act.get(field)
            if b in (None, 0) or a is None:
                continue
            if a > b * (1.0 + tolerance):
                verdict = "BREACH"
                breaches.append(
                    f"{key}: {field} {a:.4g} > budget {b:.4g} "
                    f"(+{(a / b - 1) * 100:.1f}%, tolerance "
                    f"{tolerance * 100:.0f}%)")
            elif a < b / (1.0 + tolerance) and verdict == "ok":
                verdict = "improved"
        if verdict == "improved":
            improved.append(key)
        rows.append((key, bud, act, verdict))
    stale = sorted(set(entries) - set(measured))
    return dict(breaches=breaches, missing=missing, stale=stale,
                improved=improved, rows=rows)


def render_budget_table(rows) -> str:
    out = [f"{'entry (sig digest)':<52s} {'field':<14s} "
           f"{'budget':>12s} {'actual':>12s}  verdict"]
    for key, bud, act, verdict in rows:
        first = True
        for field in _BUDGET_FIELDS:
            b = "-" if bud is None or bud.get(field) is None \
                else f"{bud[field]:.4g}"
            a = "-" if act.get(field) is None else f"{act[field]:.4g}"
            label = key if first else ""
            tag = verdict if first else ""
            out.append(f"{label:<52s} {field:<14s} {b:>12s} {a:>12s}  "
                       f"{tag}")
            first = False
    return "\n".join(out)


# ------------------------------------------------------------ fleet audit ---

_INGEST = ("stream.ingest_instances", "service.ingest")
_MAX_ROUNDS = 64


def _spilled_everywhere(h) -> bool:
    import torch
    s = h.spills.reshape(-1, h.spills.shape[-1])[:, :-1]
    return bool(torch.all(s > 0))


def _stream(rng, shape, dtype, device):
    """Uniform (row, col) keys in [0, 2**20) and values of ``dtype``."""
    import numpy as np
    import torch
    rows = torch.as_tensor(rng.integers(0, 1 << 20, shape, dtype=np.int32))
    cols = torch.as_tensor(rng.integers(0, 1 << 20, shape, dtype=np.int32))
    if dtype.is_floating_point:
        vals = torch.as_tensor(rng.standard_normal(shape,
                                                   dtype=np.float32))
    else:
        vals = torch.as_tensor(rng.integers(-100, 100, shape,
                                            dtype=np.int32))
    return (rows.to(device), cols.to(device), vals.to(dtype).to(device))


class _Fleet:
    """The concrete states and streams behind a config's ``fleet_jobs``:
    the fleet and one instance, filled by the recorded ingest sequences
    and then read by the query entries."""

    def __init__(self, sig, I, T, Q, dtype, device):
        import numpy as np

        from repro_torch.core import distributed, hier
        from repro_torch.core import semiring as sr_mod
        sr = sr_mod.get(sig.sr)
        self.sig, self.I, self.T, self.Q = sig, I, T, Q
        self.dtype, self.device = dtype, device
        self.rng = np.random.default_rng(0)
        self.empty = distributed.create_instances(
            I, sig.cuts, sig.block_size, dtype, sr, device=device)
        self.states = self.empty
        self.h = hier.create(sig.cuts, sig.block_size, dtype, sr,
                             device=device)

    def ingest_drive(self, first):
        """Rounds of [I, T, B] blocks until every layer spilled."""
        def drive(call, rec):
            s = first
            for _ in range(_MAX_ROUNDS):
                with rec.paused():
                    blk = _stream(self.rng, (self.I, self.T,
                                             self.sig.block_size),
                                  self.dtype, self.device)
                out = call(s, *blk)
                s = out[0] if isinstance(out, tuple) else out
                with rec.paused():
                    if _spilled_everywhere(s):
                        break
            with rec.paused():
                self.states = s
        return drive

    def update_drive(self, first):
        """Blocks of B into one instance until every layer spilled."""
        def drive(call, rec):
            h = first
            for _ in range(_MAX_ROUNDS * self.T):
                with rec.paused():
                    blk = _stream(self.rng, (self.sig.block_size,),
                                  self.dtype, self.device)
                h = call(h, *blk, None)
                with rec.paused():
                    if _spilled_everywhere(h):
                        break
            with rec.paused():
                self.h = h
        return drive

    def queries(self, h):
        """Half live keys of the deepest layer, half random keys."""
        import torch
        deep = h.layers[-1]
        half = self.Q // 2
        hi = deep.hi.reshape(-1, deep.hi.shape[-1])[0, :half]
        lo = deep.lo.reshape(-1, deep.lo.shape[-1])[0, :half]
        rnd = _stream(self.rng, (self.Q - half,), torch.int32, self.device)
        return (torch.cat([hi, rnd[0]]).contiguous(),
                torch.cat([lo, rnd[1]]).contiguous())


def _records_for(jobs, fleet: _Fleet) -> List[AuditRecord]:
    """Concrete records for ``fleet_jobs``' entries, in dispatch order:
    the ingest sequences first, so the read entries see their state."""
    by_entry = {e: (w, a) for e, w, a in jobs}
    out = []
    for entry in _INGEST:
        if entry in by_entry:
            w, _ = by_entry[entry]
            first = _clone_tree(fleet.empty)
            blk = _stream(fleet.rng, (fleet.I, fleet.T,
                                      fleet.sig.block_size),
                          fleet.dtype, fleet.device)
            rec = record(w, first, *blk, entry=entry,
                         drive=fleet.ingest_drive(first))
            rec.trace
            out.append(rec)
    if "hier.update" in by_entry:
        w, _ = by_entry["hier.update"]
        blk = _stream(fleet.rng, (fleet.sig.block_size,), fleet.dtype,
                      fleet.device)
        rec = record(w, fleet.h, *blk, None, entry="hier.update",
                     drive=fleet.update_drive(fleet.h))
        rec.trace
        out.append(rec)
    for entry, (w, _) in by_entry.items():
        if entry in _INGEST or entry == "hier.update":
            continue
        single = entry.startswith(("hier.", "query.engine.")) \
            and entry != "hier.metrics_snapshot"
        state = fleet.h if single else fleet.states
        if entry.endswith(("point_query", "point_lookup")):
            args = (state,) + fleet.queries(state)
        else:
            args = (state,)
        args = _clone_tree(args)
        rec = record(w, *args, entry=entry)
        rec.trace
        out.append(rec)
    order = {e: i for i, (e, _, _) in enumerate(jobs)}
    return sorted(out, key=lambda r: order[r.entry])


def audit_fleet(cfg=None, *, audit_cfg: Optional[AuditConfig] = None,
                src: Sequence[str] = (DEFAULT_SRC,),
                baseline_path: str = DEFAULT_BASELINE,
                device=None, **fleet_kw) -> dict:
    """Record a config's whole dispatch set (``stages.fleet_jobs`` — the
    SAME jobs ``precompile_fleet`` makes) over the call sequence of the
    module docstring and run every rule.

    Returns ``violations`` (every hit), ``suppressed`` (allowed in-tree),
    ``fresh`` (neither allowed nor baselined — the failing set),
    ``measured`` (the cost rows budgets are checked against) and the
    ``records``.  ``cfg`` defaults to the d4m-stream smoke config and
    ``device`` to the CPU; ``fleet_kw`` goes to ``fleet_jobs``
    (``instances``, ``blocks``, ``queries``, ``analytics_num_rows``...)."""
    import torch

    from repro_torch import stages
    if cfg is None:
        from repro_torch.configs import d4m_stream
        cfg = d4m_stream.smoke_config()
    if not isinstance(cfg, stages.Signature) \
            and "analytics_num_rows" not in fleet_kw:
        scale = int(getattr(cfg, "rmat_scale", 0) or 0)
        if scale:
            fleet_kw["analytics_num_rows"] = 1 << scale
    if fleet_kw.get("mesh") is not None:
        raise NotImplementedError(
            "tracekit records the single-process dispatch set; the fleet "
            "across ranks is held to it by chip_smoke.py phase 12")
    device = torch.device(device or "cpu")
    jobs = stages.fleet_jobs(cfg, device=device, **fleet_kw)
    sig = cfg if isinstance(cfg, stages.Signature) \
        else stages.signature_of(cfg)
    I = fleet_kw.get("instances") or getattr(cfg, "instances_per_device", 4)
    T = fleet_kw.get("blocks") or getattr(cfg, "blocks_per_step", 8)
    Q = fleet_kw.get("queries") or getattr(cfg, "query_batch", 256)
    fleet = _Fleet(sig, I, T, Q, getattr(torch, sig.dtype), device)
    records = _records_for(jobs, fleet)
    violations = run_rules(records, audit_cfg)
    allows = _scan(list(src)) if src else []
    unsuppressed = [v for v in violations
                    if not _suppressed_in_tree(v, allows)]
    base = _baseline.load_baseline(baseline_path)
    fresh = _baseline.new_violations(unsuppressed, base)
    return dict(records=records, violations=violations,
                suppressed=[v for v in violations
                            if _suppressed_in_tree(v, allows)],
                fresh=fresh, measured=measure(records))


_BASELINE_HEADER = (
    "# tracekit baseline — accepted pre-existing debt, one\n"
    "# 'RULE entry detail' key per violation.  Regenerate with\n"
    "#   python -m repro_torch.analysis.tracekit --write-baseline\n"
    "# New violations (keys not in this file) fail the audit; prefer\n"
    "# reasoned '# tracekit: allow(J00x) entry=<glob> <reason>' comments\n"
    "# in-tree so the debt stays visible next to its owner.\n")


def _resolve_config(name: str):
    from repro_torch.configs import d4m_stream
    return (d4m_stream.config() if name == "production"
            else d4m_stream.smoke_config())


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracekit",
        description="recorded-call audit + cost budgets over the fleet "
                    "dispatch set (J001-J006)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", default=True,
                      help="audit + budget check (default); exit 1 on new "
                      "violations or budget breaches")
    mode.add_argument("--update", action="store_true",
                      help="regenerate COST_BUDGETS.json with a printed "
                      "diff against the committed budgets")
    mode.add_argument("--write-baseline", action="store_true",
                      help="accept current J-violations as the baseline")
    ap.add_argument("--config", default="smoke",
                    choices=("smoke", "production"),
                    help="fleet config to audit (default: smoke — the "
                    "entry set is identical, only shapes differ)")
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS,
                    help="budget file (default: the committed "
                    "analysis/COST_BUDGETS.json)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--src", nargs="*", default=[DEFAULT_SRC],
                    help="source tree scanned for allow comments")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="budget tolerance (default: the budget file's, "
                    f"else {DEFAULT_TOLERANCE})")
    ap.add_argument("--const-bytes", type=int, default=None,
                    help="J002 threshold in bytes")
    ap.add_argument("--retrace-limit", type=int, default=None,
                    help="J006 distinct-signature limit")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    acfg = AuditConfig()
    if args.const_bytes is not None:
        acfg.const_bytes = args.const_bytes
    if args.retrace_limit is not None:
        acfg.retrace_limit = args.retrace_limit

    result = audit_fleet(_resolve_config(args.config), audit_cfg=acfg,
                         src=args.src, baseline_path=args.baseline)
    fresh, measured = result["fresh"], result["measured"]

    if args.write_baseline:
        unsuppressed = [v for v in result["violations"]
                        if v not in result["suppressed"]]
        _baseline.write_baseline(args.baseline, unsuppressed,
                                 _BASELINE_HEADER)
        print(f"baseline written: {len(unsuppressed)} entries -> "
              f"{args.baseline}")
        return 0

    budgets = load_budgets(args.budgets)
    tol = args.tolerance if args.tolerance is not None \
        else budgets.get("_meta", {}).get("tolerance", DEFAULT_TOLERANCE)

    if args.update:
        diff = compare_budgets(measured, budgets, tol)
        write_budgets(args.budgets, measured, tol, config=args.config)
        print(f"budgets written: {len(measured)} entries -> "
              f"{args.budgets}")
        if not args.quiet:
            print(render_budget_table(diff["rows"]))
            for line in diff["breaches"]:
                print(f"  was-breach: {line}")
            for key in diff["stale"]:
                print(f"  dropped stale entry: {key}")
        return 0

    # --check
    if not args.quiet:
        for v in fresh:
            print(v.render())
    counts = _baseline.per_rule_counts(result["violations"], RULES)
    fresh_counts = _baseline.per_rule_counts(fresh, RULES)
    print("tracekit per-rule counts (total / new):")
    for rule in sorted(counts):
        print(f"  {rule}: {counts[rule]} / {fresh_counts.get(rule, 0)}"
              f"  — {RULES.get(rule, 'internal')}")
    n_sup = len(result["suppressed"])
    print(f"{len(result['violations'])} violation(s), {n_sup} allowed, "
          f"{len(fresh)} new")

    diff = compare_budgets(measured, budgets, tol)
    print(f"cost budgets ({args.budgets}, tolerance {tol * 100:.0f}%):")
    print(render_budget_table(diff["rows"]))
    for line in diff["breaches"]:
        print(f"BUDGET BREACH: {line}")
    for key in diff["missing"]:
        print(f"NO BUDGET: {key} — run --update and commit the diff")
    for key in diff["stale"]:
        print(f"stale budget (not dispatched): {key}")
    ok = not fresh and not diff["breaches"] and not diff["missing"]
    print("tracekit:", "clean" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
