"""Fleet metrics, JSONL events and SLO instrumentation — the port's copy
of ``repro.obs``, host-side apart from one device entry:

- ``obs.metrics``: counters/gauges + mergeable fixed log-bucket
  histograms (the one percentile implementation of ``query.service`` and
  the SLO layer), and ``fleet_sample(states)`` → ``hier.metrics_snapshot``
  (reduced on the device, one host transfer per sample);
- ``obs.trace``: ``obs.jsonl`` events behind ``REPRO_OBS=1`` /
  ``obs.enable()``, in the JAX package's schema; spans
  (``trace.span(name, **attrs)``; every ``stages`` dispatch is one) kept
  in memory while tracing is on, written as ``span`` records by
  ``disable()`` and returned by ``trace.spans()`` until the next
  ``enable()``; and the always-on count of device-to-host reads by site
  (``trace.host_read``, ``trace.host_reads()``);
- ``obs.slo``: rolling rates, latency SLOs with breach events, and a
  non-raising stall detector for serving loops.

Aggregation: ``python -m repro_torch.launch.monitor`` (torch-free at
import) reads what ``obs.trace`` writes, spans included (count, total
and self seconds by name).
"""
from repro_torch.obs import metrics, slo, trace                    # noqa: F401
from repro_torch.obs.metrics import REGISTRY, Histogram, Registry  # noqa: F401
from repro_torch.obs.slo import RollingRate, SLOTracker, StallDetector  # noqa: F401
from repro_torch.obs.trace import disable, emit, enable, enabled   # noqa: F401

# REPRO_OBS=1 in the environment arms tracing at first import
if trace.env_enabled():
    trace.enable()
