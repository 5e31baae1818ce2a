"""Config signatures and the keyed dispatch cache — the one front door for
every staged entry point of the port (the counterpart of
``repro/stages.py``).

    wrap(fn, entry, sig)  ->  Wrapped
    Wrapped.lower(*args)  ->  Lowered      (cached per key)
    Lowered.compile()     ->  Compiled     (cached per key)

The cache key is the reference's: ``(entry, Signature, static, options)``
and then the argument tree with each tensor leaf's ``(shape, dtype,
device)``.  ``signature_of`` is also the single knob canonicalizer and
validator: an invalid combination fails with the same ``invalid d4m config
signature: ...`` message at every entry point.

**What a ``Compiled`` is here.**  Each entry declares its kind:

- ``"eager"``: the ``Compiled`` calls the function.  On the CPU every
  entry is eager, whatever it declares.
- ``"graph"`` (on a CUDA device): the first dispatch of a key runs the
  function eagerly on a side stream — the warm-up, whose result is a real
  one (an optimizer step taken there is taken).  The second captures a
  ``torch.cuda.CUDAGraph`` with the call's own argument tensors as its
  static inputs and replays it; every later dispatch replays.  At a
  replay a tensor argument is copied into its static input only when its
  memory differs from it, so state updated in place (parameters, moments,
  a KV cache) is never copied; ``Compiled.copied_bytes`` is the last
  dispatch's copy.  The static inputs are the capturing dispatch's own
  tensors, so a later dispatch with other tensors writes into them: a
  caller passes there state it hands over (passed again, or replaced by
  the returned state) or scratch it does not keep.  Outputs live in the
  graph's private pool and stay valid until the next dispatch of the same
  key, as a donated buffer does in the reference; an output that is one
  of the inputs is the static input itself, so callers use the returned
  state, never the argument.  A replay runs under
  ``set_sync_debug_mode("error")``: it makes no host read.  A capture
  that fails raises; it never falls back to eager.  The kernel wrappers'
  launch counters (``kernels/registry.py``) count at capture, when
  nothing runs: the counts made during the capture are taken back and
  added again at every replay.  A graph pins its static inputs
  and its pool until ``Wrapped.release()`` (the run that owns the state
  calls it at its end; the ``Compiled`` stays cached, so the next run
  captures again without a compile).

**Counters.**  ``stats()`` has the reference's keys — ``lowerings``,
``compiles`` (each ``Compiled`` made, whatever its kind, so "zero compiles
after warm-up" holds as in the reference), ``memory_hits``,
``disk_hits``, ``dispatches``, ``disk_writes``, ``memory_entries`` and
``per_entry`` — and the port's own ``captures``.

**Disk.**  A CUDA graph does not outlive its process.  What persists are
the kernel libraries: ``set_cache_dir(path)`` (or
``REPRO_STAGES_CACHE_DIR``) points ``kernels/build.py``'s build directory
at ``<path>/build``; ``disk_writes`` counts the libraries ``nvcc`` built
there and ``disk_hits`` the ones reused.

``precompile_fleet(cfg)`` makes a config's whole dispatch set
(``fleet_jobs``) up front, so a later ``launch/ingest`` + ``launch/query``
run adds no compile.

**Introspection**, under the reference's names.  An eager program has no
compiled module to read, so a ``Compiled`` answers from a RECORDED call
(``analysis/tracekit.py``: every aten op with its dtypes and shapes, the
host reads, the kernel launches a wrapper reported):
``Compiled.cost_analysis()`` (``"flops"`` and ``"transcendentals"`` as
XLA's cost analysis counts the reference's ops, ``"bytes accessed"``, per
call), ``as_text()`` (one aten op a line; for a ``"graph"`` entry also the
kernels a replay launches) and ``memory_analysis()`` (the reference's
attribute names; ``generated_code_size_in_bytes`` is the size of the
kernel libraries loaded).  ``cost_of(wrapped, *args)`` records one call on
clones of the tensor arguments, so an in-place entry leaves the caller's
state as it was; ``compiled_for`` returns the ``Compiled`` behind one
dispatch; ``abstract_args(key)`` rebuilds the ``Abstract`` argument tree
from a cache key; ``audit(cfg)`` runs ``tracekit.audit_fleet``.  A
``Compiled`` asked before anything was recorded records one call on zero
tensors of its key's shapes (the counterpart of the reference's
re-lowering from abstract avals): the shapes are right, the data is not.

**Sharded calls.**  A key holds each leaf's global shape, dtype and
device, not its DTensor placements, so a call lowered on DTensors cannot
be rebuilt from its key.  Such a ``Lowered`` keeps the placed arguments
it was lowered with (``Lowered.args``; ``lower(..., keep_args=True)``
keeps plain ones too, where the data matters to the count), and its
``Compiled`` records on clones of them, as ``cost_of`` does.  Both are
the caller's own objects beside the cached ones, which keep no
argument: the arguments are freed with them.  A sharded
``Compiled`` with no placed arguments raises rather than record plain
zeros.  A recorded sharded call counts one rank's share
(``analysis/tracekit.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

# Canonical knob domains — stream.py re-exports BATCH_MODES from here so
# there is exactly one source of truth for the allowed values.
BATCH_MODES = ("grouped", "bucketed", "branchfree", "switch")
L0_MODES = ("auto", "scan", "canon")
KINDS = ("eager", "graph")

_LOCK = threading.RLock()
_WRAPPED: dict = {}        # (entry, sig, static, options) -> Wrapped
_LOWERED: dict = {}        # full key -> Lowered
_COMPILED: dict = {}       # full key -> Compiled
_STATS = dict(lowerings=0, compiles=0, memory_hits=0, disk_hits=0,
              dispatches=0, disk_writes=0, captures=0)
_ENTRY_STATS: dict = {}    # entry -> dict(dispatches=int, wall_s=float)
_DIGESTS: dict = {}        # full key -> short signature digest (hook only)
_CACHE_DIR: Optional[str] = None
_SIDE_STREAMS: dict = {}   # device index -> warm-up / capture stream
_TYPES: dict = {}          # dataclass name -> type (abstract_args)

# obs.trace installs a per-dispatch hook and its dispatch span here; both
# are host-side and the off-path cost is one module-global read each per
# dispatch.
_TRACE_HOOK: Optional[Callable] = None
_TRACE_SPAN: Optional[Callable] = None


def set_trace_hook(hook: Optional[Callable], span=None) -> None:
    """Install (or clear, with ``None``) the dispatch hook.  The hook is
    called as ``hook(entry=, digest=, wall_s=, compile_s=, provenance=,
    kind=)`` after every dispatch; ``span``, when given, is called as
    ``span(entry)`` for a context manager around the call (the dispatch
    span, ``obs.trace.dispatch_span``), whose ``set`` takes the
    dispatch's ``kind``, ``provenance``, ``compile_s`` and
    ``copied_bytes`` when its ``on`` is true."""
    global _TRACE_HOOK, _TRACE_SPAN
    _TRACE_HOOK = hook
    _TRACE_SPAN = span if hook is not None else None


# ------------------------------------------------------------ signatures ----


@dataclasses.dataclass(frozen=True)
class Signature:
    """Canonical, hashable config signature — the cache key's static half.

    ``None`` fields mean "not pinned by this entry point".  ``mesh`` is
    the ``((axis name, size), ...)`` form of a ``DeviceMesh`` (every axis,
    as the reference records a ``Mesh``) or of a ``launch.mesh.FleetMesh``
    (``(("data", P),)``); ``extra`` holds entry-specific knobs as a
    ``((name, value), ...)`` tuple.
    """
    cuts: Optional[Tuple[int, ...]] = None
    block_size: Optional[int] = None
    dtype: str = "float32"
    sr: str = "plus.times"
    fused: bool = True
    lazy_l0: bool = False
    use_kernel: bool = False
    chunk: int = 1
    batch_mode: Optional[str] = None
    mesh: Tuple[Tuple[str, int], ...] = ()
    data_axes: Tuple[str, ...] = ()
    l0_mode: Optional[str] = None
    extra: Tuple[Tuple[str, Any], ...] = ()


def _invalid(msg: str) -> ValueError:
    return ValueError(f"invalid d4m config signature: {msg}")


def dtype_name(dtype) -> str:
    """Canonical name of a torch / numpy / string dtype ("float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if dtype is None:
        raise TypeError("dtype None")
    name = np.dtype(dtype).name
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return name


def signature_of(cfg=None, *, cuts=None, block_size=None, dtype=None,
                 sr=None, fused=None, lazy_l0=None, use_kernel=None,
                 chunk=None, batch_mode=None, mesh=None, data_axes=None,
                 l0_mode=None, extra=(),
                 allowed_batch_modes: Optional[Tuple[str, ...]] = None
                 ) -> Signature:
    """Canonicalize + validate a knob set into a ``Signature``.

    ``cfg`` may be a ``configs.D4MConfig`` (fields are read off it,
    keyword overrides win); a knob left ``None`` takes its default.  Bad
    cuts, unknown semirings/dtypes, ``lazy_l0`` outside plus.times, batch
    modes outside ``allowed_batch_modes`` (default: all of
    ``BATCH_MODES``), and ``data_axes`` that are not distinct axes of
    ``mesh`` (a ``DeviceMesh``, a ``FleetMesh`` or the ``((name, size),
    ...)`` form) all
    raise the same ``invalid d4m config signature: ...`` ValueError at
    every entry point.
    """
    def pick(override, attr, default):
        if override is not None:
            return override
        if cfg is not None and hasattr(cfg, attr):
            return getattr(cfg, attr)
        return default

    cuts = pick(cuts, "cuts", None)
    block_size = pick(block_size, "block_size", None)
    dtype = pick(dtype, "dtype", "float32")
    fused = bool(pick(fused, "fused", True))
    lazy_l0 = bool(pick(lazy_l0, "lazy_l0", False))
    use_kernel = bool(pick(use_kernel, "use_kernel", False))
    chunk = pick(chunk, "chunk", 1)
    batch_mode = pick(batch_mode, "batch_mode", None)
    l0_mode = pick(l0_mode, "query_l0_mode", None)

    if cuts is not None:
        try:
            cuts = tuple(int(c) for c in cuts)
        except (TypeError, ValueError):
            raise _invalid(f"cuts must be an int tuple, got {cuts!r}")
        if not cuts or any(c <= 0 for c in cuts) \
                or any(a >= b for a, b in zip(cuts, cuts[1:])):
            raise _invalid(f"cuts must be positive and strictly "
                           f"increasing, got {cuts}")
    if block_size is not None:
        block_size = int(block_size)
        if block_size < 1:
            raise _invalid(f"block_size must be >= 1, got {block_size}")
    try:
        dtype = dtype_name(dtype)
    except TypeError:
        raise _invalid(f"unknown dtype {dtype!r}")
    sr_name = getattr(sr, "name", sr)
    if sr_name is None:
        sr_name = "plus.times"
    from repro_torch.core import semiring as sr_mod
    try:
        sr_mod.get(sr_name)
    except (KeyError, ValueError):
        raise _invalid(f"unknown semiring {sr_name!r}")
    if not isinstance(chunk, int) or chunk < 1:
        raise _invalid(f"chunk must be an int >= 1, got {chunk!r}")
    allowed = allowed_batch_modes or BATCH_MODES
    if batch_mode is not None and batch_mode not in allowed:
        raise _invalid(f"batch_mode must be one of {allowed}, "
                       f"got {batch_mode!r}")
    if lazy_l0 and sr_name != "plus.times":
        raise _invalid(f"lazy_l0 requires the plus.times semiring, "
                       f"got {sr_name!r}")
    if l0_mode is not None and l0_mode not in L0_MODES:
        raise _invalid(f"l0_mode must be one of {L0_MODES}, "
                       f"got {l0_mode!r}")
    if mesh is not None and not isinstance(mesh, tuple):
        names = getattr(mesh, "mesh_dim_names", None)
        if names is not None:          # a DeviceMesh: every (axis, size)
            mesh = tuple(zip(names, mesh.shape))
        else:                          # a FleetMesh: its one axis
            mesh = tuple(zip(mesh.axis_names, (mesh.size,)))
    mesh = tuple((str(a), int(n)) for a, n in mesh or ())
    data_axes = tuple(data_axes or ())
    names = tuple(a for a, _ in mesh)
    if any(a not in names for a in data_axes) \
            or len(set(data_axes)) != len(data_axes):
        raise _invalid(f"data_axes must be distinct axes of the mesh "
                       f"{names}, got {data_axes}")
    return Signature(cuts=cuts, block_size=block_size, dtype=dtype,
                     sr=sr_name, fused=fused, lazy_l0=lazy_l0,
                     use_kernel=use_kernel, chunk=chunk,
                     batch_mode=batch_mode, mesh=mesh, data_axes=data_axes,
                     l0_mode=l0_mode, extra=tuple(extra))


def signature_for_state(h, **kw) -> Signature:
    """``signature_of`` with cuts/block_size/dtype derived from a live
    ``HierAssoc`` (batched or single-instance)."""
    l0 = h.layers[0]
    cap0 = int(l0.hi.shape[-1])
    kw.setdefault("cuts", tuple(h.cuts))
    kw.setdefault("block_size", cap0 - int(h.cuts[0]))
    kw.setdefault("dtype", l0.val.dtype)
    return signature_of(**kw)


def check_state(sig: Signature, h, block: Optional[int] = None) -> None:
    """Geometry check shared by the pinned-config entry points: the state
    and stream must match the signature they were specialized to."""
    from repro_torch.core import hier
    if tuple(h.cuts) != sig.cuts:
        raise _invalid(f"state cuts {tuple(h.cuts)} != configured "
                       f"{sig.cuts}")
    caps = hier.layer_capacities(sig.cuts, sig.block_size)
    state_caps = tuple(int(l.hi.shape[-1]) for l in h.layers)
    if state_caps != caps:
        raise _invalid(f"state capacities {state_caps} != {caps} "
                       f"(block_size {sig.block_size})")
    if dtype_name(h.layers[0].val.dtype) != sig.dtype:
        raise _invalid(f"state dtype {h.layers[0].val.dtype} != "
                       f"{sig.dtype}")
    if block is not None and block != sig.block_size:
        raise _invalid(f"stream block {block} != configured block_size "
                       f"{sig.block_size}")


# ----------------------------------------------------------------- keying ---


def _device(device) -> torch.device:
    """A device with its index filled in, so "cuda" and "cuda:0" key
    alike."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Abstract:
    """A tensor's stand-in in a cache key — shape, dtype, device — for
    ``fleet_jobs`` (the counterpart of ``jax.ShapeDtypeStruct``)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = _device(device)

    def __repr__(self):
        return (f"Abstract({self.shape}, {dtype_name(self.dtype)}, "
                f"{self.device})")


def _freeze(x):
    """Hashable, deterministic stand-in for a static value."""
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _freeze(v))
                                 for k, v in sorted(x.items(), key=repr))
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(_freeze(v) for v in x)
    try:
        hash(x)
    except TypeError:
        return repr(x)
    return x


def _children(node):
    """The (name, child) pairs of a container in a fixed order, or None
    for a leaf or a static value."""
    if isinstance(node, (torch.Tensor, Abstract)):
        return None
    if isinstance(node, (list, tuple, torch.nn.ModuleList)):
        return list(enumerate(node))
    if isinstance(node, torch.nn.Module):
        items = dict(node.named_parameters(recurse=False))
        items.update(node.named_children())
        return sorted(items.items())
    if isinstance(node, dict):
        return sorted(node.items(), key=lambda kv: repr(kv[0]))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(x, leaves: list):
    """The hashable tree structure of ``x``; its tensor (or ``Abstract``)
    leaves are appended to ``leaves`` in order."""
    if isinstance(x, (torch.Tensor, Abstract)):
        leaves.append(x)
        return "*"
    kids = _children(x)
    if kids is None:
        return ("=", _freeze(x))
    name = type(x).__name__
    if name not in _TYPES and dataclasses.is_dataclass(x):
        _TYPES[name] = type(x)
    return (name,) + tuple((k, _flatten(c, leaves)) for k, c in kids)


def tree_leaves(x) -> list:
    """The tensor leaves of an argument tree, in key order."""
    leaves = []
    _flatten(x, leaves)
    return leaves


def _leaf_key(x):
    return (tuple(x.shape), dtype_name(x.dtype), str(_device(x.device)))


def _args_key(args):
    leaves = []
    treedef = _flatten(args, leaves)
    return treedef, tuple(_leaf_key(l) for l in leaves)


def _thaw(x):
    """Inverse of ``_freeze`` for the containers it tags."""
    if isinstance(x, tuple) and x and x[0] == "seq":
        return tuple(_thaw(v) for v in x[1:])
    if isinstance(x, tuple) and x and x[0] == "dict":
        return {k: _thaw(v) for k, v in x[1:]}
    return x


def _unflatten(treedef, leaves):
    """Inverse of ``_flatten``: dataclasses come back as their type (by
    name, from the types seen while keying), tuples and lists as tuples,
    dicts and modules as dicts."""
    if treedef == "*":
        return next(leaves)
    if treedef[0] == "=":
        return _thaw(treedef[1])
    name, kids = treedef[0], treedef[1:]
    vals = [(k, _unflatten(c, leaves)) for k, c in kids]
    cls = _TYPES.get(name)
    if cls is not None:
        obj = cls.__new__(cls)
        for k, v in vals:
            object.__setattr__(obj, k, v)
        return obj
    if name in ("tuple", "list", "ModuleList"):
        return tuple(v for _, v in vals)
    return dict(vals)


def abstract_args(key) -> tuple:
    """Rebuild the abstract argument tree a cache key was lowered under:
    every tensor leaf an ``Abstract`` of its (shape, dtype, device)."""
    treedef, avals = key[4], key[5]
    leaves = iter(Abstract(shape, getattr(torch, dtype), device)
                  for shape, dtype, device in avals)
    return _unflatten(treedef, leaves)


def materialize(tree):
    """``tree`` with every ``Abstract`` leaf replaced by a zero tensor of
    its shape, dtype and device."""
    if isinstance(tree, Abstract):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(c) for c in tree)
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        obj = type(tree).__new__(type(tree))
        for f in dataclasses.fields(tree):
            object.__setattr__(obj, f.name, materialize(getattr(tree,
                                                                f.name)))
        return obj
    return tree


def abstract(tree, device):
    """``tree`` with every tensor leaf replaced by its ``Abstract`` on
    ``device`` (states built on the ``meta`` device become job arguments
    that key as the real ones will)."""
    if isinstance(tree, torch.Tensor):
        return Abstract(tree.shape, tree.dtype, device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstract(c, device) for c in tree)
    if isinstance(tree, dict):
        return {k: abstract(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: abstract(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _count(name: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[name] += n


def _note_dispatch(entry: str, wall_s: float) -> None:
    with _LOCK:
        es = _ENTRY_STATS.get(entry)
        if es is None:
            es = _ENTRY_STATS[entry] = dict(dispatches=0, wall_s=0.0)
        es["dispatches"] += 1
        es["wall_s"] += wall_s


def _key_digest(key) -> str:
    """Short config-signature digest for trace spans (memoized)."""
    with _LOCK:
        d = _DIGESTS.get(key)
    if d is None:
        text = "|".join([torch.__version__, repr(key)])
        d = hashlib.sha256(text.encode()).hexdigest()[:12]
        with _LOCK:
            _DIGESTS[key] = d
    return d


# ---------------------------------------------------------------- storage ---


def set_cache_dir(path: Optional[str]) -> None:
    """Point the persistent store at ``path`` (None detaches it): the
    kernel libraries build into, and load from, ``<path>/build``."""
    global _CACHE_DIR
    from repro_torch.kernels import build
    _CACHE_DIR = os.path.abspath(path) if path else None
    build.set_build_dir(os.path.join(_CACHE_DIR, "build")
                        if _CACHE_DIR else None)
    build.ON_BUILD = _on_build if _CACHE_DIR else None


def cache_dir() -> Optional[str]:
    return _CACHE_DIR


def _on_build(built: int, reused: int) -> None:
    """``kernels/build.py``'s report for the store: libraries ``nvcc``
    built there (``disk_writes``) and libraries found there (``disk_hits``)."""
    with _LOCK:
        _STATS["disk_writes"] += built
        _STATS["disk_hits"] += reused


# ------------------------------------------------------------ CUDA graphs ---


def _cuda_device(leaves) -> Optional[torch.device]:
    """The CUDA device of a call's tensors, or None off the card."""
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return x.device
    return None


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """One stream a device for warm-ups and captures, so the lazy state a
    warm-up creates (cuBLAS workspaces) belongs to the stream the capture
    then records on."""
    idx = _device(dev).index
    if idx not in _SIDE_STREAMS:
        _SIDE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _SIDE_STREAMS[idx]


@contextlib.contextmanager
def _sync_mode(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ----------------------------------------------------------------- stages ---


class Compiled:
    """Stage 3: the program of one key — an eager call, or on the card for
    a ``"graph"`` entry the warm-up / capture / replay cycle described in
    the module docstring."""

    def __init__(self, key, fn: Callable, kind: str, args=None,
                 sharded: bool = False):
        self.key = key
        self.fn = fn
        self.kind = kind
        self.args = args            # the placed arguments (sharded calls)
        self.sharded = sharded
        self.copied_bytes = 0       # bytes copied into static inputs, last
        self.last_kind = None       # "eager" / "graph" of the last dispatch
        self.launches = {}          # kernel launches a replay makes
        self.replays = 0
        self.replay_sync_mode = None    # sync debug mode inside a replay
        self.recorded = None        # tracekit.Trace of a recorded call
        self._warm = False
        self._graph = None
        self._static = None
        self._out = None

    def steady(self) -> bool:
        """True when the next dispatch is a replay or an eager call: a
        graph entry on the card is not, before its warm-up and capture."""
        return (self.kind != "graph" or self._graph is not None
                or self.last_kind == "eager")

    def __call__(self, *args):
        leaves = tree_leaves(args) if self.kind == "graph" else ()
        dev = _cuda_device(leaves)
        if dev is None:
            self.last_kind, self.copied_bytes = "eager", 0
            return self.fn(*args)
        self.last_kind = "graph"
        if not self._warm:
            out = self._warm_up(dev, args)
            self._warm = True
            self.copied_bytes = 0
            return out
        if self._graph is None:
            self._capture(dev, args, leaves)
        return self._replay(dev, leaves)

    def _warm_up(self, dev, args):
        cur, side = torch.cuda.current_stream(dev), _side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, dev, args, leaves) -> None:
        from repro_torch.kernels import registry
        before = registry.launches()
        graph = torch.cuda.CUDAGraph()
        side = _side_stream(dev)
        # the capture makes no host read (a read would break it); the
        # synchronize and empty_cache before it are the capture's own
        with _sync_mode(0):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.graph(graph, stream=side):
                out = self.fn(*args)
        after = registry.launches()
        counts = {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}
        registry.add_launches(counts, -1)       # nothing ran at capture
        self._graph, self._static, self._out = graph, leaves, out
        self.launches = counts
        _count("captures")

    def _replay(self, dev, leaves):
        from repro_torch.kernels import registry
        copied = 0
        with _sync_mode("error"):
            self.replay_sync_mode = torch.cuda.get_sync_debug_mode()
            for x, s in zip(leaves, self._static):
                if x.data_ptr() != s.data_ptr() or x.stride() != s.stride():
                    s.copy_(x)
                    copied += _nbytes(x)
            self._graph.replay()
        registry.add_launches(self.launches)
        self.copied_bytes = copied
        self.replays += 1
        return self._out

    def release(self) -> None:
        """Drop the captured graph, its pool and its static inputs; the
        next dispatch warms up and captures again."""
        self._warm = False
        self._graph = self._static = self._out = None

    # ------------------------------------------------------ introspection --

    def _trace(self):
        if self.recorded is None:
            from repro_torch.analysis import tracekit
            if self.args is not None:
                tracekit.record_compiled(self, self.args)
            elif self.sharded:
                raise RuntimeError(
                    f"{self.key[0]}: a sharded call is recorded on its "
                    "placed arguments, and none were kept (lower it with "
                    "them)")
            else:
                tracekit.record_compiled(
                    self, materialize(abstract_args(self.key)))
        return self.recorded

    def cost_analysis(self) -> dict:
        """The recorded call's cost under the reference's keys, per call:
        ``"flops"`` and ``"transcendentals"`` (every op, counted as XLA's
        ``HloCostAnalysis`` counts the reference's: ``FlopCounterMode``'s
        table for the matrix-class ops, ``tracekit.op_cost`` for the
        rest; a CUDA kernel's launch 0), ``"bytes accessed"`` (each op's
        tensor inputs read and outputs written once, plus the bytes the
        kernel wrappers report) and ``"peak bytes"``."""
        return self._trace().cost_dict()

    def as_text(self) -> str:
        """The recorded call as text: one aten op a line with its dtypes
        and shapes, then the kernel launches and host reads; a
        ``"graph"`` entry adds the kernels a replay launches."""
        head = f"# entry {self.key[0]} kind {self.kind}"
        text = "\n".join([head, self._trace().as_text()])
        if self.kind == "graph":
            text += "\n# replay launches " + repr(dict(self.launches))
        return text

    def memory_analysis(self) -> "MemoryAnalysis":
        """Bytes of the recorded call under the reference's attribute
        names; ``generated_code_size_in_bytes`` is the size of the kernel
        libraries loaded (0 on the CPU)."""
        from repro_torch.kernels import build
        t = self._trace()
        code = sum(build.library_path(src).stat().st_size
                   for src in build.loaded_sources()
                   if build.library_path(src).exists())
        return MemoryAnalysis(
            argument_size_in_bytes=t.arg_bytes,
            output_size_in_bytes=t.out_bytes,
            temp_size_in_bytes=t.per_call()["peak_bytes"],
            alias_size_in_bytes=t.alias_bytes,
            generated_code_size_in_bytes=code)


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """``Compiled.memory_analysis()``: the reference's attribute names."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    generated_code_size_in_bytes: int


class Lowered:
    """Stage 2: one key of a ``Wrapped``; ``compile()`` makes (or finds)
    its ``Compiled``.  ``args`` are the arguments kept for the recorded
    call (a sharded lowering's placed arguments), else None: a
    ``Lowered`` that keeps them is the caller's own, never the cached
    one, so they live as long as the caller holds it or its
    ``Compiled``."""

    def __init__(self, key, wrapped: "Wrapped", args=None,
                 sharded: bool = False):
        self.key = key
        self._wrapped = wrapped
        self.args = args
        self.sharded = sharded

    def compile(self) -> Compiled:
        """The key's cached ``Compiled``; with kept arguments, a
        ``Compiled`` of the same program that records on them (the
        caller's own, as this ``Lowered`` is)."""
        with _LOCK:
            comp = _COMPILED.get(self.key)
            if comp is None:
                comp = _COMPILED.setdefault(self.key, Compiled(
                    self.key, self._wrapped.fn, self._wrapped.kind))
                _STATS["compiles"] += 1
            else:
                _STATS["memory_hits"] += 1
        # its key cannot rebuild a sharded call's arguments
        comp.sharded = comp.sharded or self.sharded
        if self.args is None:
            return comp
        return Compiled(self.key, comp.fn, comp.kind, self.args,
                        self.sharded)


def is_sharded(leaves) -> bool:
    """True when a leaf is a DTensor (its placements are not in a key)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in leaves)


class Wrapped:
    """Stage 1: a callable bound to an entry name, a config signature and
    a kind.  Calling it dispatches through the keyed cache."""

    def __init__(self, fn: Callable, entry: str, sig: Signature,
                 static: Tuple = (), options: Tuple = (),
                 kind: str = "eager"):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.fn = fn
        self.entry = entry
        self.sig = sig
        self.static = tuple(static)
        self.options = tuple(options)
        self.kind = kind
        self.last: Optional[Compiled] = None
        self._opt_key = _freeze(self.options)

    def _key(self, args):
        treedef, avals = _args_key(args)
        return (self.entry, self.sig, self.static, self._opt_key,
                treedef, avals)

    def lower(self, *args, keep_args: Optional[bool] = None) -> Lowered:
        """Stage the function for the given (abstract or concrete) args;
        cached per key.  When the args are sharded (or with
        ``keep_args=True``) the ``Lowered`` returned is a new one that
        keeps them for its recorded call; the cache keeps none."""
        key = self._key(args)
        with _LOCK:
            low = _LOWERED.get(key)
            if low is None:
                low = _LOWERED.setdefault(key, Lowered(key, self))
                _STATS["lowerings"] += 1
        sharded = is_sharded(tree_leaves(args))
        if keep_args or (sharded and keep_args is None):
            return Lowered(key, self, args, sharded)
        if sharded:
            return Lowered(key, self, None, sharded)
        return low

    def compiled(self, *args) -> Optional[Compiled]:
        """The cached ``Compiled`` of these arguments' key, if any."""
        with _LOCK:
            return _COMPILED.get(self._key(args))

    def __call__(self, *args):
        _count("dispatches")
        t0 = time.perf_counter()
        key = self._key(args)
        with _LOCK:
            comp = _COMPILED.get(key)
        provenance, compile_s = "memory", 0.0
        if comp is not None:
            _count("memory_hits")
        else:
            c0 = time.perf_counter()
            # a dispatch keeps no argument alive in the cache
            comp = self.lower(*args, keep_args=False).compile()
            compile_s = time.perf_counter() - c0
            provenance = "compile"
        span = _TRACE_SPAN
        if span is None:
            out = comp(*args)
        else:
            with span(self.entry) as sp:
                out = comp(*args)
                if sp.on:
                    sp.set(kind=comp.last_kind, provenance=provenance,
                           compile_s=compile_s,
                           copied_bytes=comp.copied_bytes)
        self.last = comp
        wall = time.perf_counter() - t0
        _note_dispatch(self.entry, wall)
        hook = _TRACE_HOOK
        if hook is not None:
            try:
                hook(entry=self.entry, digest=_key_digest(key), wall_s=wall,
                     compile_s=compile_s, provenance=provenance,
                     kind=comp.last_kind)
            except Exception:
                pass        # observability must never break the dispatch
        return out

    def steady(self, *args):
        """Dispatch until the key's program is steady (an eager call, or a
        replaying graph: two dispatches on the card the first time);
        returns the last output.  The warm-up of a serving loop."""
        out = self(*args)
        while not self.last.steady():
            out = self(*args)
        return out

    def is_steady(self, *args) -> bool:
        """True when dispatching ``args`` now would replay or call
        eagerly — not warm up or capture.  A timed loop starts its clock
        there."""
        comp = self.compiled(*args)
        if comp is None:
            return (self.kind == "eager"
                    or _cuda_device(tree_leaves(args)) is None)
        return comp.steady()

    def release(self) -> None:
        """Release every captured graph of this ``Wrapped`` (its keys stay
        compiled)."""
        head = (self.entry, self.sig, self.static, self._opt_key)
        with _LOCK:
            comps = [c for k, c in _COMPILED.items() if k[:4] == head]
        for c in comps:
            c.release()


def wrap(fn: Callable, entry: str, sig: Optional[Signature] = None, *,
         static: Tuple = (), donate_argnums=None,
         kind: str = "eager") -> Wrapped:
    """Bind ``fn`` to the keyed cache as ``entry`` under ``sig``.

    Memoized on (entry, sig, static, options): wrapping the same
    configuration twice returns the same ``Wrapped`` (and so the same
    compiled programs and captured graphs), which lets scattered call
    sites — service builders, launch CLIs, ``precompile_fleet`` — share
    one cache entry per configuration.  ``donate_argnums`` marks the
    arguments the program updates in place (recorded in the key, as the
    reference's jit option is); ``kind`` is ``"eager"`` or ``"graph"``.
    """
    sig = sig if sig is not None else Signature()
    options = () if donate_argnums is None \
        else (("donate_argnums", tuple(donate_argnums)),)
    memo_key = (entry, sig, tuple(static), _freeze(options))
    with _LOCK:
        w = _WRAPPED.get(memo_key)
        if w is None:
            w = Wrapped(fn, entry, sig, static=tuple(static),
                        options=options, kind=kind)
            _WRAPPED[memo_key] = w
    return w


def dispatch(entry: str, sig: Signature, make_fn: Callable[[], Callable],
             *args, static: Tuple = ()):
    """Eager front door for public API functions: route a call through the
    keyed cache.  ``make_fn`` builds the knob-closed implementation; it
    runs at most once per (entry, sig, static) thanks to the ``wrap``
    memo."""
    memo_key = (entry, sig, tuple(static), _freeze(()))
    with _LOCK:
        w = _WRAPPED.get(memo_key)
    if w is None:
        w = wrap(make_fn(), entry, sig, static=static)
    return w(*args)


# ------------------------------------------------------------ bookkeeping ---


def stats(reset: bool = False) -> dict:
    """Counters: ``lowerings`` / ``compiles`` count staging work,
    ``memory_hits`` / ``disk_hits`` cache service, ``dispatches`` every
    call through a ``Wrapped``, ``captures`` the CUDA graphs recorded;
    ``per_entry`` breaks dispatches down by entry name with cumulative
    dispatch wall seconds.  ``reset=True`` snapshots and zeroes the
    counters in one locked step."""
    with _LOCK:
        out = dict(_STATS)
        out["memory_entries"] = len(_COMPILED)
        out["per_entry"] = {e: dict(v) for e, v in _ENTRY_STATS.items()}
        if reset:
            for k in _STATS:
                _STATS[k] = 0
            _ENTRY_STATS.clear()
    return out


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _ENTRY_STATS.clear()


def clear_memory_cache() -> None:
    """Drop every in-process cache entry (wrapped/lowered/compiled, and
    with them every captured graph) — a simulated cold start."""
    with _LOCK:
        _WRAPPED.clear()
        _LOWERED.clear()
        _COMPILED.clear()


def lowered_keys() -> Tuple:
    """Snapshot of every cache key lowered so far this process."""
    with _LOCK:
        return tuple(_LOWERED.keys())


def compiled_for(wrapped: Wrapped, *args) -> Compiled:
    """The ``Compiled`` behind one (wrapped, args) dispatch: the cached
    one, else lowered and compiled now."""
    comp = wrapped.compiled(*args)
    return comp if comp is not None else wrapped.lower(*args).compile()


def cost_of(wrapped: Wrapped, *args) -> dict:
    """Cost columns of one dispatch — ``flops``, ``bytes_accessed`` and
    ``peak_bytes`` — from one recorded call on clones of the tensor
    arguments (``Abstract`` leaves become zeros), so an entry that
    updates its state in place leaves the caller's state unchanged."""
    from repro_torch.analysis import tracekit
    comp = compiled_for(wrapped, *args)
    tracekit.record_compiled(comp, materialize(args))
    cost = comp.cost_analysis()
    return dict(flops=cost.get("flops"),
                bytes_accessed=cost.get("bytes accessed"),
                peak_bytes=comp.memory_analysis().temp_size_in_bytes)


def audit(cfg=None, **kw):
    """The ``stages``-side front door to ``analysis.tracekit``: audit a
    config's (or a ``Signature``'s) fleet dispatch set
    (``tracekit.audit_fleet``); imported lazily so ``stages`` never
    depends on the analysis package."""
    from repro_torch.analysis import tracekit
    return tracekit.audit_fleet(cfg, **kw)


# ------------------------------------------------------- fleet precompile ---


def fleet_jobs(cfg, *, instances: Optional[int] = None,
               blocks: Optional[int] = None,
               queries: Optional[int] = None,
               analytics_num_rows: int = 0, analytics_k: int = 8,
               mesh=None, data_axes=None, device=None) -> list:
    """Enumerate a config's production dispatch set as
    ``[(entry, Wrapped, abstract_args), ...]`` — the reference's entries,
    with ``Abstract`` arguments on ``device`` (default: the CUDA device)."""
    from repro_torch import resolve_device
    from repro_torch.core import distributed, hier, stream
    from repro_torch.core import semiring as sr_mod
    from repro_torch.query import engine, service

    sig = cfg if isinstance(cfg, Signature) else signature_of(cfg)
    sr = sr_mod.get(sig.sr)
    dtype = getattr(torch, sig.dtype)
    dev = resolve_device(device)
    I = (instances if instances is not None
         else getattr(cfg, "instances_per_device", 4))
    T = blocks if blocks is not None else getattr(cfg, "blocks_per_step", 8)
    Q = queries if queries is not None else getattr(cfg, "query_batch", 256)
    B = sig.block_size
    cuts = sig.cuts

    states_abs = abstract(distributed.create_instances(
        I, cuts, B, dtype, sr, device="meta"), dev)
    h_abs = abstract(hier.create(cuts, B, dtype, sr, device="meta"), dev)
    stream_abs = tuple(Abstract((I, T, B), d, dev)
                       for d in (torch.int32, torch.int32, dtype))
    block_abs = tuple(Abstract((B,), d, dev)
                      for d in (torch.int32, torch.int32, dtype))
    q_abs = (Abstract((Q,), torch.int32, dev),
             Abstract((Q,), torch.int32, dev))

    jobs = []
    # ingest-side sigs never pin the query-only l0_mode knob
    ingest_sig = dataclasses.replace(sig, l0_mode=None)
    jobs.append(("stream.ingest_instances",
                 stream.ingest_instances_jit(ingest_sig),
                 (states_abs,) + stream_abs))
    jobs.append(("service.ingest",
                 service.make_ingest_fn(
                     sr, use_kernel=sig.use_kernel, lazy_l0=sig.lazy_l0,
                     fused=sig.fused, chunk=sig.chunk,
                     batch_mode=sig.batch_mode or "grouped"),
                 (states_abs,) + stream_abs))
    jobs.append(("service.point_query",
                 service.make_point_query_fn(
                     sr, use_kernel=sig.use_kernel,
                     l0_mode=sig.l0_mode or "auto"),
                 (states_abs,) + q_abs))
    if analytics_num_rows:
        jobs.append(("service.analytics",
                     service.make_analytics_fn(analytics_num_rows,
                                               analytics_k, sr),
                     (states_abs,)))
    # single-instance core ops; hier.update executes switch/branchfree only
    single_mode = "branchfree" if sig.batch_mode == "branchfree" \
        else "switch"
    single_sig = dataclasses.replace(ingest_sig, batch_mode=single_mode,
                                     chunk=1)
    jobs.append(("hier.update", hier.update_wrapped(single_sig),
                 (h_abs,) + block_abs + (None,)))
    jobs.append(("hier.flush", hier.flush_wrapped(single_sig), (h_abs,)))
    jobs.append(("hier.query_all", hier.query_all_wrapped(single_sig),
                 (h_abs,)))
    jobs.append(("query.engine.point_lookup",
                 engine.point_lookup_wrapped(
                     dataclasses.replace(single_sig,
                                         l0_mode=sig.l0_mode or "auto")),
                 (h_abs,) + q_abs))
    # the fleet observability sample pins geometry alone
    jobs.append(("hier.metrics_snapshot",
                 hier.metrics_snapshot_wrapped(
                     signature_of(cuts=cuts, block_size=B, dtype=dtype)),
                 (states_abs,)))
    if mesh is not None:
        jobs.append(("distributed.sharded_ingest_fn",
                     distributed.sharded_ingest_fn(
                         mesh, data_axes, sr, lazy_l0=sig.lazy_l0,
                         use_kernel=sig.use_kernel, fused=sig.fused,
                         chunk=sig.chunk,
                         batch_mode=sig.batch_mode or "grouped"),
                     (states_abs,) + stream_abs))
        jobs.append(("distributed.sharded_query_fn",
                     distributed.sharded_query_fn(
                         mesh, data_axes, sr, use_kernel=sig.use_kernel,
                         l0_mode=sig.l0_mode or "auto"),
                     (states_abs,) + q_abs))
    return jobs


def kernel_jobs() -> list:
    """The CUDA kernel families' representative jobs
    (``repro_torch.kernels.registry.jobs()``) — the kernel-level sibling
    of ``fleet_jobs``."""
    from repro_torch.kernels import registry
    return registry.jobs()


def precompile_fleet(cfg, *, instances: Optional[int] = None,
                     blocks: Optional[int] = None,
                     queries: Optional[int] = None,
                     analytics_num_rows: int = 0, analytics_k: int = 8,
                     mesh=None, data_axes=None, device=None) -> dict:
    """Make a ``D4MConfig``'s (or a ``Signature``'s) whole dispatch set
    once, at launch: every job of ``fleet_jobs`` lowered and compiled
    against its abstract arguments, so a later ``launch/ingest`` +
    ``launch/query`` run of the same shapes adds no compile.  Graph
    entries capture at their own second dispatch (a graph needs real
    tensors).  Returns ``{entry: "compiled" | "cached"}`` (the
    reference's ``"disk"`` never appears: no program outlives its
    process)."""
    jobs = fleet_jobs(cfg, instances=instances, blocks=blocks,
                      queries=queries,
                      analytics_num_rows=analytics_num_rows,
                      analytics_k=analytics_k, mesh=mesh,
                      data_axes=data_axes, device=device)
    report = {}
    for entry, wrapped, args in jobs:
        before = stats()
        if wrapped.compiled(*args) is None:
            wrapped.lower(*args).compile()
        report[entry] = ("compiled" if stats()["compiles"]
                         > before["compiles"] else "cached")
    return report


# The environment's cache dir applies at import, as in the reference.
if os.environ.get("REPRO_STAGES_CACHE_DIR"):
    set_cache_dir(os.environ["REPRO_STAGES_CACHE_DIR"])
