"""Structured JSONL events behind ``REPRO_OBS``.

When tracing is enabled (``REPRO_OBS=1`` or ``obs.enable()``), ``emit``
appends one JSON line per event to ``<obs_dir>/obs.jsonl``: the service
summary, SLO breaches, stalls, fleet samples and metric snapshots.  The
schema is the JAX package's, so the stdlib-only
``python -m repro_torch.launch.monitor --obs-dir <dir>`` (the port's copy
of the reference's monitor) aggregates the port's files, and either
package's monitor reads either package's files.

- **Host-side only.**  Nothing here runs on the device; the off-path
  cost is one module-global read per ``emit`` or ``span``.  The one read
  of tensors is the collection of a session's device-scalar attributes
  at ``disable()``.
- **Mergeable across N processes.**  Records are appended with a single
  ``os.write`` on an ``O_APPEND`` fd — atomic on POSIX for these line
  sizes — so any number of processes can share one ``obs.jsonl``.  Every
  record carries a per-process ``run`` id, a monotonic ``seq``, a
  wall-clock ``t`` and ``pid``.

- **Dispatch records.**  Every call through the ``stages`` front door is
  a *dispatch*: ``enable`` installs ``_on_dispatch`` as its hook, and
  each becomes one ``dispatch`` record (entry, signature digest, wall
  time, compile seconds, cache provenance — the reference's fields — and
  the port's ``kind``: ``eager`` or ``graph``).

- **Spans.**  ``span(name, **attrs)`` is a context manager around one
  piece of a layer's work.  Tracing off, it reads one module global and
  returns the shared no-op ``NO_SPAN`` (``.on`` False); a call site
  builds an attribute that costs more than a local read only under
  ``if sp.on``.  Tracing on, each span keeps ``(id, parent, dispatch,
  name, start_ns, end_ns, attrs)`` in memory: the parent is the
  innermost span open on the thread, and ``dispatch`` is the id of the
  outermost dispatch span above it (the request every span under one
  dispatch shares).  Every dispatch is itself a span named after its
  entry, with ``kind``, ``provenance``, ``compile_s`` and
  ``copied_bytes`` (a graph replay's copy into its static inputs).
  Times are ``time.time_ns()``, the Unix-epoch clock ``torch.profiler``'s
  events carry, so a span lines up with a device trace by its clock
  alone.  With ``enable(annotate=True)`` (or ``REPRO_OBS_ANNOTATE=1``) a
  dispatch span also opens ``torch.profiler.record_function(entry)``;
  no span below a dispatch opens a profiler range (a range that
  launched kernels shows as an annotation on the device side too).  A
  span opened while a CUDA graph is being captured is not kept: the
  replay's dispatch span stands for it.  A tensor attribute (a device
  scalar) stays a tensor until the session's spans are collected, when
  all of them are read to the host at once.  A session keeps at most
  ``MAX_SPANS`` spans and counts the rest in ``dropped``.  ``disable()``
  collects the session, writes each span as a ``span`` record (``name``,
  ``id``, ``parent``, ``dispatch``, ``start_ns``, ``end_ns``, ``attrs``)
  and keeps it for ``spans()`` until the next ``enable()``.

- **Host reads.**  ``host_read(site)`` counts one device-to-host read at
  a named site, always, tracing on or off (``host_reads()``): the fleet
  step's depth plan (``stream.plan``), ``hier``'s single-instance plan and
  layer-count reads (``hier.plan``, ``hier.cascade``,
  ``hier.execute_fit``, ``hier.update_fit``) and ``vassoc``'s spill and
  drain flags (``vassoc``).  ``spans()`` holds the counts at ``enable``
  and at ``disable``.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import uuid
from typing import Optional

ENV = "REPRO_OBS"
ENV_DIR = "REPRO_OBS_DIR"
ENV_ANNOTATE = "REPRO_OBS_ANNOTATE"
DEFAULT_DIR = "obs"
FILENAME = "obs.jsonl"
# every record must carry these — the monitor's schema check
SCHEMA_FIELDS = ("ev", "run", "seq", "t", "pid")
MAX_SPANS = 2 ** 20          # spans one session keeps

_LOCK = threading.Lock()
_STATE = dict(enabled=False, fd=None, path=None, run=None, seq=0)

# spans: the one flag the off path reads, the open session, the last
# collected one
_RECORDING = False
_SESSION = dict(spans=[], dropped=0, reads=None, annotate=None,
                capturing=None)
_COLLECTED: Optional[dict] = None
_IDS = itertools.count(1)
_TLS = threading.local()      # .stack: the thread's open spans

_READS_LOCK = threading.Lock()
_READS: dict = {}             # site -> device-to-host reads, always on


def env_enabled(env: Optional[str] = None) -> bool:
    """Unset, empty and ``"0"`` mean off."""
    v = os.environ.get(ENV) if env is None else env
    return v not in (None, "", "0")


def enabled() -> bool:
    return _STATE["enabled"]


def run_id() -> Optional[str]:
    return _STATE["run"]


def out_path() -> Optional[str]:
    return _STATE["path"]


def enable(obs_dir: Optional[str] = None, *,
           annotate: Optional[bool] = None) -> str:
    """Open ``<obs_dir>/obs.jsonl`` (default ``REPRO_OBS_DIR`` or
    ``obs``) for appending, install the stages dispatch hook and start a
    span session.  Idempotent; returns the JSONL path."""
    global _RECORDING, _COLLECTED
    from repro_torch import stages
    with _LOCK:
        if _STATE["enabled"]:
            return _STATE["path"]
        d = obs_dir or os.environ.get(ENV_DIR) or DEFAULT_DIR
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, FILENAME)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        _STATE.update(enabled=True, fd=fd, path=path,
                      run=uuid.uuid4().hex[:12], seq=0)
    if annotate is None:
        annotate = env_enabled(os.environ.get(ENV_ANNOTATE))
    import torch
    ann = None
    if annotate:
        from torch.profiler import record_function as ann
    capturing = None
    if torch.cuda.is_available():
        def capturing():
            return (torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing())
    _SESSION.update(spans=[], dropped=0, reads=host_reads(), annotate=ann,
                    capturing=capturing)
    _COLLECTED = None
    _RECORDING = True
    stages.set_trace_hook(_on_dispatch, span=dispatch_span)
    emit("obs_start", argv=list(sys.argv))
    return path


def disable() -> None:
    """Uninstall the hook, collect the span session (its ``span`` records
    are written, and ``spans()`` returns it) and close the stream."""
    global _RECORDING, _COLLECTED
    from repro_torch import stages
    stages.set_trace_hook(None)
    if _RECORDING:
        _RECORDING = False
        reads = host_reads()
        _COLLECTED = _collect(_SESSION["spans"], _SESSION["dropped"],
                              dict(enable=_SESSION["reads"], disable=reads))
        _SESSION.update(spans=[], dropped=0, reads=None, annotate=None,
                        capturing=None)
        for rec in _COLLECTED["spans"]:
            emit("span", **rec)
    with _LOCK:
        fd = _STATE["fd"]
        _STATE.update(enabled=False, fd=None, path=None, run=None, seq=0)
    if fd is not None:
        os.close(fd)


def emit(ev: str, **fields) -> bool:
    """Append one event record; no-op (returns False) when disabled.
    Never raises into the caller — observability must not break the path
    it watches."""
    with _LOCK:
        if not _STATE["enabled"]:
            return False
        _STATE["seq"] += 1
        rec = dict(ev=ev, run=_STATE["run"], seq=_STATE["seq"],
                   t=time.time(), pid=os.getpid())
        rec.update(fields)
        try:
            line = json.dumps(rec, separators=(",", ":")) + "\n"
            os.write(_STATE["fd"], line.encode())
        except (OSError, TypeError, ValueError):
            return False
    return True


def _on_dispatch(*, entry: str, digest: str, wall_s: float,
                 compile_s: float, provenance: str, kind: str) -> None:
    """The hook ``stages.Wrapped.__call__`` fires per dispatch."""
    emit("dispatch", entry=entry, sig=digest, wall_s=round(wall_s, 9),
         compile_s=round(compile_s, 6), prov=provenance, kind=kind)


# ------------------------------------------------------------------ spans --


class _NoSpan:
    """The shared span of the off path: keeps nothing."""
    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    """One kept span; appended to the session when it closes."""
    __slots__ = ("name", "attrs", "id", "parent", "dispatch", "start_ns",
                 "_is_dispatch", "_range")
    on = True

    def __init__(self, name: str, attrs: dict, is_dispatch: bool):
        self.name, self.attrs = name, attrs
        self._is_dispatch = is_dispatch
        self._range = None

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.id = next(_IDS)
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.dispatch = None if top is None else top.dispatch
        if self.dispatch is None and self._is_dispatch:
            self.dispatch = self.id
        stack.append(self)
        ann = _SESSION["annotate"] if self._is_dispatch else None
        self.start_ns = time.time_ns()
        if ann is not None:
            self._range = ann(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        end_ns = time.time_ns()
        _TLS.stack.pop()
        spans = _SESSION["spans"]
        if len(spans) < MAX_SPANS:
            spans.append((self.id, self.parent, self.dispatch, self.name,
                          self.start_ns, end_ns, self.attrs))
        else:
            _SESSION["dropped"] += 1
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def _open(name: str, attrs: dict, is_dispatch: bool):
    capturing = _SESSION["capturing"]
    if capturing is not None and capturing():
        return NO_SPAN
    return _Span(name, attrs, is_dispatch)


def span(name: str, **attrs):
    """A span of ``name`` around the ``with`` block (``NO_SPAN`` when
    tracing is off or a CUDA graph is being captured)."""
    if not _RECORDING:
        return NO_SPAN
    return _open(name, attrs, False)


def dispatch_span(entry: str):
    """The span of one ``stages`` dispatch (installed as its hook's
    ``span``): named after its entry, the request id of every span under
    it, and with ``annotate`` a profiler range of the same name."""
    if not _RECORDING:
        return NO_SPAN
    return _open(entry, {}, True)


def _to_host(t) -> list:
    return t.tolist()


def _collect(spans: list, dropped: int, reads: dict) -> dict:
    """The session as plain records, its device-scalar attributes read to
    the host in one read a device and dtype."""
    import torch
    groups: dict = {}
    for rec in spans:
        for k, v in rec[6].items():
            if isinstance(v, torch.Tensor):
                groups.setdefault((v.device, v.dtype), []).append(
                    (rec[6], k, v))
    for items in groups.values():
        values = _to_host(torch.stack([v.reshape(()) for _, _, v in items]))
        for (attrs, k, _), x in zip(items, values):
            attrs[k] = x
    out = [dict(name=name, id=i, parent=parent, dispatch=disp,
                start_ns=t0, end_ns=t1, attrs=attrs)
           for i, parent, disp, name, t0, t1, attrs in spans]
    return dict(spans=out, dropped=dropped, host_reads=reads)


def spans() -> Optional[dict]:
    """The last collected session, until the next ``enable()``:
    ``{"spans": [record, ...], "dropped": int, "host_reads": {"enable":
    {site: n}, "disable": {site: n}}}``, each record a dict of ``name``,
    ``id``, ``parent``, ``dispatch``, ``start_ns``, ``end_ns`` and
    ``attrs``; None before the first ``disable()`` of a session."""
    return _COLLECTED


# ------------------------------------------------------------ host reads --


def host_read(site: str) -> None:
    """Count one device-to-host read at ``site`` (always on)."""
    with _READS_LOCK:
        _READS[site] = _READS.get(site, 0) + 1


def host_reads() -> dict:
    """Every site's device-to-host reads since the process started."""
    with _READS_LOCK:
        return dict(_READS)
