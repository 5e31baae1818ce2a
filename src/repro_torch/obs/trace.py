"""Structured JSONL events behind ``REPRO_OBS``.

When tracing is enabled (``REPRO_OBS=1`` or ``obs.enable()``), ``emit``
appends one JSON line per event to ``<obs_dir>/obs.jsonl``: the service
summary, SLO breaches, stalls, fleet samples and metric snapshots.  The
schema is the JAX package's, so the stdlib-only
``python -m repro.launch.monitor --obs-dir <dir>`` aggregates the port's
files unchanged (run it as a separate command; the port never imports
it).

- **Host-side only.**  Nothing here touches a tensor; the off-path cost
  is one module-global read per ``emit``.
- **Mergeable across N processes.**  Records are appended with a single
  ``os.write`` on an ``O_APPEND`` fd — atomic on POSIX for these line
  sizes — so any number of processes can share one ``obs.jsonl``.  Every
  record carries a per-process ``run`` id, a monotonic ``seq``, a
  wall-clock ``t`` and ``pid``.

- **Dispatch spans.**  Every call through the ``stages`` front door is a
  *dispatch*: ``enable`` installs ``_on_dispatch`` as its hook, and each
  becomes one ``dispatch`` record (entry, signature digest, wall time,
  compile seconds, cache provenance — the reference's fields — and the
  port's ``kind``: ``eager`` or ``graph``).  ``enable(annotate=True)``
  (or ``REPRO_OBS_ANNOTATE=1``) nests each dispatch in a
  ``torch.profiler.record_function(entry)`` so spans line up with device
  traces.
"""
from __future__ import annotations

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

_LOCK = threading.Lock()
_STATE = dict(enabled=False, fd=None, path=None, run=None, seq=0)


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
    ``obs``) for appending and install the stages dispatch hook.
    Idempotent; returns the JSONL path."""
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
    ann = None
    if annotate:
        from torch.profiler import record_function as ann
    stages.set_trace_hook(_on_dispatch, annotation=ann)
    emit("obs_start", argv=list(sys.argv))
    return path


def disable() -> None:
    """Uninstall the hook and close the stream (flushes nothing — every
    record was already written atomically)."""
    from repro_torch import stages
    stages.set_trace_hook(None)
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
