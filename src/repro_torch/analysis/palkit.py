"""palkit — CUDA kernel-level audit and committed shared-memory budgets (the
counterpart of ``repro/analysis/palkit.py``).

``repro_torch.analysis.lint`` audits SOURCE and ``tracekit`` what the
fleet entries DO; neither sees what the hand-written kernels do on the
card: a launch the C side refuses, a block that is not a whole number of
warps, shared memory over the H100's ceiling, an out-of-bounds read that
happens to return the right value, a barrier phase never waited.  The
kernels run only on the card, so palkit audits them there, over the same
universe the parity tests and ``chip_smoke.py`` phase 3 use:
``kernels/registry.py::jobs()``, and the kernels at the main path's
shapes, ``registry.main_path_jobs()``: one universe for the audit, its
children and the budgets.

Run as::

    python -m repro_torch.analysis.palkit --check     # on the card
    python -m repro_torch.analysis.palkit --update    # regenerate budgets

Without a CUDA device it exits 2 ("no CUDA device"): nothing here falls
back to the CPU, and no rule is skipped.

Rules (each the Hopper counterpart of the reference's rule of the id):

K000  The kernel fails to build, or a job fails to launch at its registry
      shapes, or a sanitizer tool that started ends without its summary
      (a crash, a timeout, a child that did not finish its jobs) —
      reported as a violation, never raised.
K001  Misalignment: a launch whose block is not a multiple of 32 threads,
      or a 16-byte vector path (``bag_kernel<4>``, the ring kernel's bulk
      copies, ``carry_kernel<4, *>``) taken for operands that are not
      16-byte aligned.
K002  Per-CTA shared memory, static (``cudaFuncGetAttributes``) plus
      dynamic (the launch configuration), over the H100's 232,448 bytes;
      and, with ``--check``, over the job's committed budget in
      ``analysis/SMEM_BUDGETS.json`` by more than the tolerance, or a job
      with no budget.
K003  Out-of-bounds accesses: ``compute-sanitizer --tool memcheck``, or
      the checked build's bounds checks.
K004  An output read before it is written: ``--tool initcheck``, or the
      checked build run twice with outputs and scratch poisoned with two
      different bytes (outputs that differ read memory never written).
K005  The kernel diverges from its plain version at the job's shapes,
      beyond the job's ``rtol`` (integer outputs exact).
K006  Async-copy and barrier discipline: ``--tool synccheck`` and ``--tool
      racecheck``, or the checked build's warp-collective, bounded-wait,
      bulk-copy-alignment and copies-started-equal-copies-waited checks.

The launch configuration (grid, block, dynamic shared memory) is the C
side's own decision, read through each library's ``<P>_launch_config``
(a dry run of the routine that launches); resources come from
``<P>_kernel_attrs`` and, for spills, from the ``-Xptxas=-v`` log the build
keeps beside each library (``parse_ptxas``).  See ``kernels/analysis.cuh``.

**The sanitizer.**  K003, K004 and K006 run each of the four tools over a
child process (``python -m repro_torch.analysis.palkit --run-jobs``) with
``--error-exitcode`` and ``--kernel-name regex=...`` naming the six kernel
functions, so only they are instrumented.  A tool that cannot run on the
machine (``Error: Device not supported``, or no ``compute-sanitizer``) is
reported as unavailable with its message — and its rules are then checked
by the checked build (``-DREPRO_KERNEL_CHECKS``, a ``--run-jobs
--checked`` child started beside the tools'), never skipped.  The checked
build has no shared-memory race detector: where racecheck cannot run, K006
rests on the checked build's sync checks and the report names racecheck's
class as not covered (``STANDS_IN``).  Only "unavailable" hands a tool
over to the checked build: a tool that started and failed is K000.

Suppression mirrors tracekit: allows are PER KERNEL JOB —

    # palkit: allow(K00x) kernel=<glob> <reason>

anywhere in the audited source tree; the glob is over job names and the
reason is mandatory.  Accepted debt can also live in the committed
baseline (``palkit_baseline.txt``, the ``analysis.baseline`` machinery —
it starts and stays empty).
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import baseline as _baseline

RULES = {
    "K000": "kernel fails to build or launch at its registry shapes, or a "
            "sanitizer tool ends without its summary",
    "K001": "block not a multiple of 32, or a 16-byte vector path on "
            "unaligned operands",
    "K002": "per-CTA shared memory over the H100 ceiling (232,448 B)",
    "K003": "out-of-bounds access (memcheck / checked build)",
    "K004": "output read before it is written (initcheck / poisoned "
            "checked runs)",
    "K005": "kernel diverges from its plain version beyond the job's rtol",
    "K006": "async-copy / barrier discipline (synccheck, racecheck / "
            "checked build)",
}

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
DEFAULT_BASELINE = os.path.join(_HERE, "palkit_baseline.txt")
DEFAULT_BUDGETS = os.path.join(_HERE, "SMEM_BUDGETS.json")
DEFAULT_SRC = os.path.join(_ROOT, "src", "repro_torch")
DEFAULT_TOLERANCE = 0.10
SMEM_CEILING = 232_448          # shared memory a block can use on an H100

TOOLS = ("memcheck", "initcheck", "synccheck", "racecheck")
TOOL_RULE = {"memcheck": "K003", "initcheck": "K004", "synccheck": "K006",
             "racecheck": "K006"}
CHECK_RULE = {"bounds": "K003", "init": "K004", "sync": "K006"}
# the checked build's class that stands in for a tool that cannot run;
# racecheck has none (the checked build has no shared-memory race detector)
STANDS_IN = {"memcheck": "bounds", "initcheck": "init", "synccheck": "sync",
             "racecheck": None}
RACE_NOT_COVERED = ("its class is NOT covered: the checked build has no "
                    "shared-memory race detector")
KERNELS = ("prepare_kernel", "merge_kernel", "bag_kernel", "ring_kernel",
           "rows_kernel", "carry_kernel")
KERNEL_REGEX = "|".join(KERNELS)
# kernels that read 16-byte vectors
VECTOR_KERNELS = ("bag_kernel<4>", "ring_kernel", "carry_kernel<4")
# a family's row operand (the table, the messages): the one the vector
# path reads by rows, and whose row count the kernel's arguments do not
# carry (the checked build's extent)
_ROWS_OPERAND = {"embedding_bag": 0, "segment_agg": 0}
_PREFIX = {"hier_merge": "hm", "embedding_bag": "eb", "segment_agg": "sa"}
_RUN_TIMEOUT = 900

_ALLOW_RE = re.compile(
    r"#\s*palkit:\s*allow\(([A-Za-z0-9, ]+)\)\s+kernel=(\S+)\s*(.*)$")


class NoDevice(RuntimeError):
    """palkit needs a CUDA device: the kernels build and run only there."""


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    kernel: str
    detail: str          # stable scope token — the baseline identity
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule} {self.kernel} {self.detail}"

    def render(self) -> str:
        return f"{self.kernel}: {self.rule} {self.message}"


@dataclasses.dataclass
class AuditConfig:
    """Rule thresholds.  ``smem_limit_bytes``: K002's absolute per-CTA
    ceiling (the H100's 232,448 bytes)."""
    smem_limit_bytes: int = SMEM_CEILING


# --------------------------------------------------------------- records ----


@dataclasses.dataclass
class KernelRecord:
    """One audited job: its launches (each with ``kernel``, ``grid``,
    ``block``, ``smem_static``, ``smem_dynamic``, ``regs``,
    ``spill_bytes``, ``vector`` and ``aligned``), a build or launch
    failure, the comparison with the plain version, and the memory and
    sync checks — per sanitizer tool (an error count, or None when the
    tool could not run), the tools that started and failed
    (``tool_failures``, K000), and from the checked build."""
    name: str
    family: str
    launches: List[dict] = dataclasses.field(default_factory=list)
    failure: Optional[str] = None
    max_abs_err: Optional[float] = None
    diverged: Optional[str] = None
    tools: Dict[str, Optional[int]] = dataclasses.field(default_factory=dict)
    tool_failures: Dict[str, str] = dataclasses.field(default_factory=dict)
    checked: Optional[Dict[str, int]] = None

    def smem_bytes(self) -> int:
        return max((l["smem_static"] + l["smem_dynamic"]
                    for l in self.launches), default=0)

    def resources(self) -> dict:
        """Registers, shared memory and spills: the largest over the
        job's launches."""
        ls = self.launches
        return dict(
            regs=max((l["regs"] for l in ls), default=0),
            smem_static=max((l["smem_static"] for l in ls), default=0),
            smem_dynamic=max((l["smem_dynamic"] for l in ls), default=0),
            spill_bytes=max((l["spill_bytes"] for l in ls), default=0))

    def check_counts(self) -> Dict[str, Optional[int]]:
        """Errors per rule of K003/K004/K006: a tool's count where the
        tool ran, else the checked build's; None when neither ran."""
        out: Dict[str, Optional[int]] = {}
        for rule in ("K003", "K004", "K006"):
            ran = [n for t, n in self.tools.items()
                   if TOOL_RULE[t] == rule and n is not None]
            if len(ran) == sum(1 for t in TOOL_RULE.values() if t == rule) \
                    and ran:
                out[rule] = sum(ran)
            elif self.checked is not None:
                out[rule] = sum(n for k, n in self.checked.items()
                                if CHECK_RULE.get(k) == rule)
                out[rule] += sum(ran)
            else:
                out[rule] = None
        return out


# ----------------------------------------------------------------- rules ----


def _k000(rec: KernelRecord, cfg: AuditConfig) -> Iterable[Violation]:
    if rec.failure:
        yield Violation("K000", rec.name, "launch",
                        f"kernel failed to build or launch at its registry "
                        f"shapes — {rec.failure}")
    for tool, why in sorted(rec.tool_failures.items()):
        yield Violation("K000", rec.name, f"sanitizer:{tool}",
                        f"compute-sanitizer {tool} started but did not "
                        f"finish — {why}")


def _k001(rec: KernelRecord, cfg: AuditConfig) -> Iterable[Violation]:
    seen: Set[str] = set()
    for l in rec.launches:
        if l["block"] % 32 and f"block:{l['kernel']}" not in seen:
            seen.add(f"block:{l['kernel']}")
            yield Violation(
                "K001", rec.name, f"block:{l['kernel']}",
                f"{l['kernel']} launches {l['block']} threads a block, not "
                "a multiple of the 32-thread warp: the last warp runs "
                "partly empty and warp collectives lose lanes")
        if l.get("vector") and not l.get("aligned", True) \
                and f"vector:{l['kernel']}" not in seen:
            seen.add(f"vector:{l['kernel']}")
            yield Violation(
                "K001", rec.name, f"vector:{l['kernel']}",
                f"{l['kernel']} reads 16-byte vectors but the job's "
                "operand is not 16-byte aligned (or its row is not a "
                "whole number of vectors): a misaligned vector access "
                "faults")


def _k002(rec: KernelRecord, cfg: AuditConfig) -> Iterable[Violation]:
    for l in rec.launches:
        total = l["smem_static"] + l["smem_dynamic"]
        if total > cfg.smem_limit_bytes:
            yield Violation(
                "K002", rec.name, "ceiling",
                f"{l['kernel']} asks {total} bytes of shared memory a "
                f"block ({l['smem_static']} static + {l['smem_dynamic']} "
                f"dynamic), over the {cfg.smem_limit_bytes}-byte ceiling "
                "— the launch is refused")
            return


def _checks(rule: str, what: str):
    def rule_fn(rec: KernelRecord, cfg: AuditConfig) -> Iterable[Violation]:
        n = rec.check_counts()[rule]
        if n:
            tools = {t: c for t, c in rec.tools.items()
                     if TOOL_RULE[t] == rule}
            yield Violation(
                rule, rec.name, what,
                f"{n} error(s) — sanitizer {tools}, checked build "
                f"{rec.checked}")
    return rule_fn


def _k005(rec: KernelRecord, cfg: AuditConfig) -> Iterable[Violation]:
    if rec.diverged:
        yield Violation("K005", rec.name, "divergence",
                        f"kernel != plain version: {rec.diverged}")


_RULE_FNS = (_k000, _k001, _k002, _checks("K003", "oob"),
             _checks("K004", "uninit"), _k005, _checks("K006", "sync"))


def run_rules(records: Sequence[KernelRecord],
              cfg: Optional[AuditConfig] = None) -> List[Violation]:
    """All K-rule violations over ``records`` (unsuppressed view — allows
    and baseline are applied by the caller/CLI)."""
    cfg = cfg or AuditConfig()
    out: List[Violation] = []
    for rec in records:
        for rule in _RULE_FNS:
            out.extend(rule(rec, cfg))
    return sorted(out, key=lambda v: (v.kernel, v.rule, v.detail))


# --------------------------------------------------------------- parsers ----

_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) "
                         r"barriers)?(?:, (\d+) bytes smem)?")


def parse_ptxas(log: str) -> Dict[str, dict]:
    """``-Xptxas=-v`` output -> {mangled entry name: regs, barriers,
    smem_static, stack, spill_stores, spill_loads}."""
    entries: Dict[str, dict] = {}
    props: Dict[str, Tuple[int, int, int]] = {}
    entry = target = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            entries.setdefault(entry, dict(regs=0, barriers=0,
                                           smem_static=0))
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            target = m.group(1)
            continue
        m = _PTXAS_SPILL.search(line)
        if m and target:
            props[target] = tuple(int(x) for x in m.groups())
            continue
        m = _PTXAS_USED.search(line)
        if m and entry:
            entries[entry].update(regs=int(m.group(1)),
                                  barriers=int(m.group(2) or 0),
                                  smem_static=int(m.group(3) or 0))
    for name, row in entries.items():
        stack, stores, loads = props.get(name, (0, 0, 0))
        row.update(stack=stack, spill_stores=stores, spill_loads=loads)
    return entries


def demangle(names: Sequence[str]) -> Dict[str, str]:
    """Mangled -> demangled names through ``c++filt`` (the names unchanged
    where it is missing)."""
    names = list(names)
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) errors?")
_RACE_SUMMARY = re.compile(r"RACECHECK SUMMARY: (\d+) hazards? displayed "
                           r"\((\d+) errors?, (\d+) warnings?\)")
_UNAVAILABLE = ("Device not supported", "Unable to find injection",
                "could not be found", "Target application terminated "
                "before first instrumented API call",
                "Failed to initialize")
_KERNEL_AT = re.compile(r"\b(" + KERNEL_REGEX + r")\b")


def parse_sanitizer(text: str, tool: str) -> dict:
    """One compute-sanitizer run's output -> ``status`` ("ok": it ran to
    its summary; "unavailable": it could not run on this machine;
    "failed": no summary), ``errors`` (the summary's count; racecheck's
    errors, warnings apart), ``per_kernel`` (error lines naming one of the
    six kernels) and ``message``."""
    lines = [l for l in text.splitlines() if l.startswith("=========")]
    for l in lines:
        body = l.strip("= ").strip()
        if body.startswith("Error:") and any(u in body for u in
                                             _UNAVAILABLE):
            return dict(status="unavailable", errors=None, per_kernel={},
                        message=body)
    # one count per kernel a report names ("at <kernel>(...)+0x.. in
    # file:line"); reports are separated by a bare "=========" line
    per_kernel: Dict[str, int] = {}
    named: Set[str] = set()
    for l in lines + ["========="]:
        if not l.strip("= ").strip():
            for k in named:
                per_kernel[k] = per_kernel.get(k, 0) + 1
            named = set()
            continue
        m = _KERNEL_AT.search(l) if " at " in l else None
        if m:
            named.add(m.group(1))
    if tool == "racecheck":
        m = _RACE_SUMMARY.search(text)
        errors = int(m.group(2)) if m else None
    else:
        m = _SUMMARY.search(text)
        errors = int(m.group(1)) if m else None
    if errors is None:
        return dict(status="failed", errors=None, per_kernel=per_kernel,
                    message="no summary line: the tool did not finish")
    return dict(status="ok", errors=errors, per_kernel=per_kernel,
                message=(m.group(0) if m else ""))


# ------------------------------------------------------------ on the card ---


def _require_device():
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("palkit: no CUDA device — the kernels build and run "
                       "only on the card (run it there; nothing here falls "
                       "back to the CPU)")


def _families() -> dict:
    """family -> (its source, its wrapper module's library loader)."""
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.hier_merge import hier_merge as hm
    from repro_torch.kernels.segment_agg import segment_agg as sa
    return {"hier_merge": (hm.SOURCE, hm._lib),
            "embedding_bag": (eb.SOURCE, eb._lib),
            "segment_agg": (sa.SOURCE, sa._lib)}


def kernel_resources() -> Tuple[Dict[str, List[dict]], Dict[str, str]]:
    """Build every source; per family the resources of every kernel
    instantiation (``cudaFuncGetAttributes`` joined with the ptxas log:
    ``spill_stores``, ``spill_loads``, ``spill_bytes``, ``stack``,
    ``demangled``), and per family a build failure's message."""
    from repro_torch.kernels import build
    out: Dict[str, List[dict]] = {}
    failures: Dict[str, str] = {}
    for family, (src, lib) in _families().items():
        try:
            attrs = build.kernel_attrs(lib(), _PREFIX[family])
        except (RuntimeError, OSError) as e:
            failures[family] = f"{type(e).__name__}: {e}"[:2000]
            continue
        log = build.log_path(src)
        ptx = parse_ptxas(log.read_text()) if log.exists() else {}
        names = demangle([a["mangled"] for a in attrs if a["mangled"]])
        for a in attrs:
            p = ptx.get(a["mangled"] or "", {})
            a.update(spill_stores=p.get("spill_stores", 0),
                     spill_loads=p.get("spill_loads", 0),
                     stack=p.get("stack", 0),
                     ptxas_regs=p.get("regs"),
                     ptxas_smem=p.get("smem_static"),
                     demangled=names.get(a["mangled"], a["name"]))
            a["spill_bytes"] = a["spill_stores"] + a["spill_loads"]
        out[family] = attrs
    return out, failures


def _device_args(x):
    import numpy as np
    import torch
    if isinstance(x, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(x), device="cuda")
    if isinstance(x, list):
        return [_device_args(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_device_args(v) for v in x)
    return x


def _flat(out) -> list:
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def compare(got, want, rtol: float) -> Tuple[float, Optional[str]]:
    """(max abs error, None or what differs): integer outputs exact, float
    outputs within rtol (atol = rtol) with equal NaN patterns."""
    import torch
    err, why = 0.0, None
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        if g.shape != w.shape:
            return float("inf"), f"output {i}: shape {tuple(g.shape)} != " \
                                 f"{tuple(w.shape)}"
        if not g.dtype.is_floating_point:
            if not torch.equal(g, w):
                why = why or f"output {i} ({g.dtype}) differs"
            continue
        gd, wd = g.double(), w.double()
        if not torch.equal(torch.isnan(gd), torch.isnan(wd)):
            why = why or f"output {i}: NaN patterns differ"
            continue
        ok = ~torch.isnan(wd)
        if bool(ok.any()):
            d = float((gd[ok] - wd[ok]).abs().max())
            err = max(err, d)
            if not torch.allclose(gd[ok], wd[ok], rtol=rtol, atol=rtol):
                why = why or f"output {i}: max abs error {d:.3g} over " \
                             f"rtol {rtol}"
    return err, why


def _aligned(job, args) -> bool:
    """The job's vector operand 16-byte aligned, rows whole vectors."""
    idx = _ROWS_OPERAND.get(job.family)
    if idx is None:
        return True
    t = args[idx]
    return t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0


def record_job(job, resources: Dict[str, List[dict]],
               failures: Dict[str, str]) -> KernelRecord:
    """Launch one job on the card: its launch configuration (from the C
    side) joined with the kernels' resources, and the kernel against its
    plain version.  A failure becomes ``rec.failure`` (K000)."""
    import torch
    rec = KernelRecord(job.name, job.family)
    if job.family in failures:
        rec.failure = f"build failed: {failures[job.family]}"
        return rec
    try:
        args = _device_args(job.make_inputs(0))
        launches = job.launch_config(*args)
        got = job.fn(*args)
        torch.cuda.synchronize()
        want = job.plain(*args)
        torch.cuda.synchronize()
    except Exception as e:                  # noqa: BLE001 — reported (K000)
        rec.failure = f"{type(e).__name__}: {e}"[:2000]
        return rec
    table = resources[job.family]
    for l in launches:
        if not 0 <= l["kernel"] < len(table):
            rec.failure = f"launch config names kernel {l['kernel']}, not " \
                          f"in the library's table of {len(table)}"
            return rec
        k = table[l["kernel"]]
        vector = k["name"].startswith(VECTOR_KERNELS)
        rec.launches.append(dict(
            kernel=k["name"], grid=l["grid"], block=l["block"],
            smem_static=k["smem_static"], smem_dynamic=l["smem_dynamic"],
            regs=k["regs"], spill_bytes=k["spill_bytes"], vector=vector,
            aligned=_aligned(job, args) if vector else True))
    rec.max_abs_err, rec.diverged = compare(got, want, job.rtol)
    del args, got, want
    torch.cuda.empty_cache()
    return rec


def _jobs() -> list:
    """The audit's universe: the registry's jobs and the kernels at the
    main path's shapes."""
    from repro_torch.kernels import registry
    return list(registry.jobs()) + list(registry.main_path_jobs())


def _child_env() -> dict:
    env = dict(os.environ)
    src = os.path.join(_ROOT, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env


def _child_cmd(out: str, checked: bool) -> list:
    return ([sys.executable, "-m", "repro_torch.analysis.palkit",
             "--run-jobs", "--out", out]
            + (["--checked"] if checked else []))


def sanitizer_path() -> Optional[str]:
    path = shutil.which("compute-sanitizer") \
        or "/usr/local/cuda/bin/compute-sanitizer"
    return path if os.path.exists(path) else None


def _run_children(cmds: Dict[str, Tuple[list, dict]]
                  ) -> Dict[str, Tuple[int, str, float]]:
    """Start every child at once and wait for all: (exit code, output,
    seconds until it ended) each."""
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=env)
             for k, (cmd, env) in cmds.items()}
    out = {}
    for k, p in procs.items():
        try:
            text, _ = p.communicate(timeout=_RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + "\n(timed out)"
        out[k] = (p.returncode, text, time.perf_counter() - t0)
    return out


def sanitize(records: Sequence[KernelRecord],
             tools: Sequence[str] = TOOLS) -> dict:
    """K003/K004/K006 over the jobs: each compute-sanitizer tool over a
    ``--run-jobs`` child, and beside them the checked build over a
    ``--run-jobs --checked`` child, all started at once; the checked
    build's counts stand for a tool that is unavailable, and a tool that
    started but failed goes to every record's ``tool_failures`` (K000).
    Fills ``rec.tools``, ``rec.tool_failures`` and ``rec.checked``;
    returns the per-tool report (status, errors, message, seconds, and
    for a tool that did not run what stands in for it)."""
    report: Dict[str, dict] = {}
    by_name = {r.name: r for r in records}
    cs = sanitizer_path()
    with tempfile.TemporaryDirectory() as tmp:
        outs = {k: os.path.join(tmp, f"{k}.json")
                for k in (*tools, "checked")}
        cmds = {"checked": (_child_cmd(outs["checked"], True),
                            _child_env())}
        if cs is not None:
            for tool in tools:
                cmds[tool] = ([cs, "--tool", tool, "--error-exitcode", "86",
                               "--kernel-name", f"regex={KERNEL_REGEX}",
                               *_child_cmd(outs[tool], False)],
                              _child_env())
        done = _run_children(cmds)
        for tool in tools:
            if cs is None:
                res = dict(status="unavailable", errors=None, per_kernel={},
                           message="compute-sanitizer not found", seconds=0)
            else:
                rc, text, secs = done[tool]
                res = parse_sanitizer(text, tool)
                res.update(exit=rc, seconds=secs)
                if res["status"] == "ok" and not os.path.exists(outs[tool]):
                    res.update(status="failed",
                               message="the jobs did not run to their end")
                if res["status"] == "failed":
                    res["message"] += " — " + text.strip()[-500:]
            if res["status"] == "unavailable":
                cls = STANDS_IN[tool]
                res["stand_in"] = (f"its class is checked by the checked "
                                   f"build ({cls})" if cls
                                   else RACE_NOT_COVERED)
            report[tool] = res
            for rec in records:
                if res["status"] != "ok":
                    rec.tools[tool] = None
                    if res["status"] == "failed":
                        rec.tool_failures[tool] = (
                            f"{res['message']} (exit {res.get('exit')})")
                    continue
                names = {l["kernel"].split("<")[0] for l in rec.launches}
                rec.tools[tool] = sum(n for k, n in res["per_kernel"].items()
                                      if k in names)
                if res["errors"] and not res["per_kernel"]:
                    rec.tools[tool] = res["errors"]
        rc, text, secs = done["checked"]
        ran = os.path.exists(outs["checked"])
        result = {}
        if ran:
            with open(outs["checked"], encoding="utf-8") as fh:
                result = json.load(fh)
        report["checked_build"] = dict(
            status="ok" if ran and rc == 0 else "failed", exit=rc,
            seconds=secs, message=text[-2000:] if rc else "")
        for name, row in result.items():
            rec = by_name.get(name)
            if rec is None:
                continue
            if row.get("error"):
                rec.failure = rec.failure or f"checked build: {row['error']}"
                continue
            rec.checked = dict(bounds=row["bounds"], init=row["init"],
                               sync=row["sync"])
        if not ran or rc:
            for rec in records:
                if rec.checked is None and not rec.failure:
                    rec.failure = "checked build run failed: " + text[-1500:]
    return report


def _check_api(lib, p: str) -> dict:
    """The checked build's exports of one library (``analysis.cuh``),
    with their C signatures declared."""
    import ctypes
    api = {}
    for name, args, res in (
            ("checked", [], ctypes.c_int),
            ("check_counts", [ctypes.POINTER(ctypes.c_uint)], ctypes.c_int),
            ("check_poison", [ctypes.c_int], None),
            ("check_extent", [ctypes.c_longlong], None)):
        fn = getattr(lib, f"{p}_{name}")
        fn.argtypes, fn.restype = args, res
        api[name] = fn
    return api


def run_jobs(out: str, checked: bool) -> int:
    """The child of ``sanitize``: run every job once on the card.  With
    ``checked`` each job runs twice on the checked libraries, outputs and
    scratch poisoned with 0x00 then 0xFF, and its check counts are read;
    the results go to ``out`` as JSON."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    if checked:
        build.use_checked_libraries()
    build.build_all(checked=checked)
    libs = {f: lib for f, (_, lib) in _families().items()}
    result = {}
    for job in _jobs():
        try:
            args = _device_args(job.make_inputs(0))
            if not checked:
                job.fn(*args)
                torch.cuda.synchronize()
                result[job.name] = dict(ran=True)
                continue
            p = _PREFIX[job.family]
            api = _check_api(libs[job.family](), p)
            if api["checked"]() != 1:
                raise RuntimeError(f"{p}: not the checked library")
            counts = (ctypes.c_uint * 3)()
            api["check_counts"](counts)                   # zero them
            i = _ROWS_OPERAND.get(job.family)
            api["check_extent"](int(args[i].shape[0]) if i is not None
                                else 0)
            outs = []
            for byte in (0x00, 0xFF):
                api["check_poison"](byte)
                got = job.fn(*args)
                torch.cuda.synchronize()
                outs.append([t.clone() for t in _flat(got)])
            api["check_poison"](-1)
            api["check_extent"](0)
            err = api["check_counts"](counts)
            if err:
                raise RuntimeError(f"{p}_check_counts: CUDA error {err}")
            same = all(torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8))
                       for a, b in zip(*outs))
            result[job.name] = dict(bounds=int(counts[0]),
                                    init=int(counts[1]) + (0 if same else 1),
                                    sync=int(counts[2]), poison_equal=same)
        except Exception as e:              # noqa: BLE001 — reported (K000)
            result[job.name] = dict(error=f"{type(e).__name__}: {e}"[:2000])
        finally:
            torch.cuda.empty_cache()
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(result, fh, indent=1)
    print(f"palkit --run-jobs: {len(result)} job(s) done", flush=True)
    return 0


# ----------------------------------------------------------- suppression ----


def scan_allows(paths: Sequence[str]) -> List[Tuple[Set[str], str, str]]:
    """Collect ``# palkit: allow(K00x) kernel=<glob> <reason>`` comments
    from the source tree; a missing reason does not suppress."""
    from repro_torch.analysis.lint import iter_py_files
    out: List[Tuple[Set[str], str, str]] = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                m = _ALLOW_RE.search(line)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
                    out.append((rules, m.group(2), m.group(3).strip()))
    return out


def suppressed(v: Violation,
               allows: Sequence[Tuple[Set[str], str, str]]) -> bool:
    return any(v.rule in rules and reason
               and fnmatch.fnmatchcase(v.kernel, glob)
               for rules, glob, reason in allows)


# ---------------------------------------------------------------- budgets ---

_BUDGET_FIELDS = ("smem_bytes",)


def measure(records: Sequence[KernelRecord]) -> Dict[str, dict]:
    """Per-job rows keyed by job name: the largest per-CTA shared memory
    over its launches (static + dynamic), with registers, spills, the
    kernels launched and the check counts beside it."""
    out: Dict[str, dict] = {}
    for rec in records:
        if rec.failure:
            continue
        res = rec.resources()
        out[rec.name] = dict(
            family=rec.family,
            kernels=sorted({l["kernel"] for l in rec.launches}),
            launches=len(rec.launches), smem_bytes=rec.smem_bytes(),
            regs=res["regs"], smem_static=res["smem_static"],
            smem_dynamic=res["smem_dynamic"],
            spill_bytes=res["spill_bytes"])
    return out


def load_budgets(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_budgets(path: str, measured: Dict[str, dict],
                  tolerance: float) -> None:
    import torch
    payload = {
        "_meta": dict(
            tolerance=tolerance,
            generated=time.strftime("%Y-%m-%dT%H:%M:%S"),
            torch=torch.__version__, cuda=torch.version.cuda,
            device=torch.cuda.get_device_name(0),
            command="python -m repro_torch.analysis.palkit --update",
            note="committed per-job per-CTA shared memory (bytes, static "
                 "+ dynamic, the largest over the job's launches) with "
                 "registers and spills beside it — --check fails when a "
                 "job exceeds its budget by more than the tolerance or is "
                 "unbudgeted",
        ),
        "kernels": {k: measured[k] for k in sorted(measured)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")


def compare_budgets(measured: Dict[str, dict], budgets: dict,
                    tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Budget-vs-actual diff, same verdicts as tracekit: ``breaches``
    (actual > budget * (1+tol)), ``missing`` (audited but unbudgeted),
    ``stale`` (budgeted but gone from the registry), ``improved``
    (ratchet candidates), and the full ``rows`` table."""
    entries = budgets.get("kernels", {})
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
                    f"{key}: {field} {a} > budget {b} "
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
    out = [f"{'kernel job':<52s} {'smem':>8s} {'budget':>8s} {'regs':>5s} "
           f"{'spill':>6s}  verdict"]
    for key, bud, act, verdict in rows:
        b = "-" if bud is None or bud.get("smem_bytes") is None \
            else str(bud["smem_bytes"])
        out.append(f"{key:<52s} {act.get('smem_bytes', 0):>8d} {b:>8s} "
                   f"{act.get('regs', 0):>5d} {act.get('spill_bytes', 0):>6d}"
                   f"  {verdict}")
    return "\n".join(out)


# ----------------------------------------------------------- kernel audit ---


def audit_kernels(jobs=None, *, audit_cfg: Optional[AuditConfig] = None,
                  src: Sequence[str] = (DEFAULT_SRC,),
                  baseline_path: str = DEFAULT_BASELINE,
                  tools: Sequence[str] = TOOLS) -> dict:
    """Build, launch and check every job on the card and run every K
    rule.  Returns ``violations`` (every hit), ``suppressed`` (allowed
    in-tree), ``fresh`` (neither allowed nor baselined — the failing
    set), ``measured`` (the shared-memory rows budgets are checked
    against), ``resources`` (every kernel instantiation), ``sanitizer``
    (the per-tool report) and the ``records``.  Raises ``NoDevice``
    without a CUDA device."""
    _require_device()
    jobs = _jobs() if jobs is None else list(jobs)
    resources, failures = kernel_resources()
    records = [record_job(job, resources, failures) for job in jobs]
    report = sanitize(records, tools)
    violations = run_rules(records, audit_cfg)
    allows = scan_allows(list(src)) if src else []
    unsuppressed = [v for v in violations if not suppressed(v, allows)]
    base = _baseline.load_baseline(baseline_path)
    fresh = _baseline.new_violations(unsuppressed, base)
    return dict(records=records, violations=violations,
                suppressed=[v for v in violations if suppressed(v, allows)],
                fresh=fresh, measured=measure(records),
                resources=resources, sanitizer=report)


_BASELINE_HEADER = (
    "# palkit baseline — accepted pre-existing debt, one\n"
    "# 'RULE kernel detail' key per violation.  Regenerate with\n"
    "#   python -m repro_torch.analysis.palkit --write-baseline\n"
    "# New violations (keys not in this file) fail the audit; prefer\n"
    "# reasoned '# palkit: allow(K00x) kernel=<glob> <reason>' comments\n"
    "# in-tree so the debt stays visible next to its owner.\n")


def _report_json(result: dict) -> dict:
    return dict(
        jobs={r.name: dict(family=r.family, launches=r.launches,
                           failure=r.failure, max_abs_err=r.max_abs_err,
                           diverged=r.diverged, tools=r.tools,
                           tool_failures=r.tool_failures,
                           checked=r.checked, checks=r.check_counts())
              for r in result["records"]},
        measured=result["measured"], resources=result["resources"],
        sanitizer=result["sanitizer"],
        violations=[v.key for v in result["violations"]],
        fresh=[v.render() for v in result["fresh"]],
        suppressed=[v.key for v in result["suppressed"]])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.palkit",
        description="CUDA kernel-level audit + shared-memory budgets over "
                    "the kernel registry (K000-K006), on the card")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", default=True,
                      help="audit + budget check (default); exit 1 on new "
                      "violations, budget breaches, or unbudgeted jobs")
    mode.add_argument("--update", action="store_true",
                      help="regenerate SMEM_BUDGETS.json with a printed "
                      "diff against the committed budgets")
    mode.add_argument("--write-baseline", action="store_true",
                      help="accept current K-violations as the baseline")
    mode.add_argument("--run-jobs", action="store_true",
                      help="(the audit's child) run every job once; with "
                      "--checked, on the checked libraries")
    ap.add_argument("--checked", action="store_true",
                    help="with --run-jobs: the checked build's runs")
    ap.add_argument("--out", default=None,
                    help="with --run-jobs: where the child writes its JSON")
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS,
                    help="budget file (default: the committed "
                    "analysis/SMEM_BUDGETS.json)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--src", nargs="*", default=[DEFAULT_SRC],
                    help="source tree scanned for allow comments")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="budget tolerance (default: the budget file's, "
                    f"else {DEFAULT_TOLERANCE})")
    ap.add_argument("--smem-limit", type=int, default=None,
                    help="K002 absolute per-CTA shared-memory ceiling")
    ap.add_argument("--json", default=None,
                    help="also write the full report to this file")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    try:
        _require_device()
    except NoDevice as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.run_jobs:
        return run_jobs(args.out or os.devnull, args.checked)

    acfg = AuditConfig()
    if args.smem_limit is not None:
        acfg.smem_limit_bytes = args.smem_limit
    result = audit_kernels(audit_cfg=acfg, src=args.src,
                           baseline_path=args.baseline)
    fresh, measured = result["fresh"], result["measured"]
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(_report_json(result), fh, indent=1, sort_keys=True)

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
        write_budgets(args.budgets, measured, tol)
        print(f"budgets written: {len(measured)} jobs -> {args.budgets}")
        if not args.quiet:
            print(render_budget_table(diff["rows"]))
            for line in diff["breaches"]:
                print(f"  was-breach: {line}")
            for key in diff["stale"]:
                print(f"  dropped stale job: {key}")
        return 0

    # --check
    if not args.quiet:
        for v in fresh:
            print(v.render())
    for tool, rep in result["sanitizer"].items():
        print(f"sanitizer {tool}: {rep['status']}"
              + (f", {rep.get('errors')} error(s)" if rep.get("errors")
                 is not None else "")
              + (f" — {rep['message']}" if rep.get("message") else "")
              + (f"; {rep['stand_in']}" if rep.get("stand_in") else ""))
    counts = _baseline.per_rule_counts(result["violations"], RULES)
    fresh_counts = _baseline.per_rule_counts(fresh, RULES)
    print("palkit per-rule counts (total / new):")
    for rule in sorted(counts):
        print(f"  {rule}: {counts[rule]} / {fresh_counts.get(rule, 0)}"
              f"  — {RULES.get(rule, 'internal')}")
    n_sup = len(result["suppressed"])
    print(f"{len(result['violations'])} violation(s), {n_sup} allowed, "
          f"{len(fresh)} new")

    diff = compare_budgets(measured, budgets, tol)
    print(f"shared-memory budgets ({args.budgets}, tolerance "
          f"{tol * 100:.0f}%):")
    print(render_budget_table(diff["rows"]))
    for line in diff["breaches"]:
        print(f"BUDGET BREACH: {line}")
    for key in diff["missing"]:
        print(f"NO BUDGET: {key} — run --update and commit the diff")
    for key in diff["stale"]:
        print(f"stale budget (job left the registry): {key}")
    ok = not fresh and not diff["breaches"] and not diff["missing"]
    print("palkit:", "clean" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
