"""reprolint — AST lint for the port's front-door and canonical-form
contracts (the counterpart of ``repro/analysis/lint.py``).

Stdlib ``ast`` only: it imports neither torch nor jax, so CI lints without
the accelerator stack.  Run as::

    python -m repro_torch.analysis.lint src/repro_torch

Rules — each is the PyTorch form of the reference's rule of the same id:

R001  A capture or compile outside ``repro_torch/stages.py``:
      ``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
      ``torch.cuda.make_graphed_callables``, ``torch.compile``,
      ``torch.jit.script`` or ``torch.jit.trace`` (attribute, call,
      decorator, or a ``from`` import alias).  The reference's bare
      ``jax.jit``: ``stages.wrap(..., kind="graph")`` is the one front door
      that captures, keys its programs and counts them — route through it.
R002  A ``torch.vmap`` / ``torch.func.vmap`` module reaching a branch on a
      tensor value — ``torch.cond``, or an ``if`` / ``while`` whose test
      reads a tensor (``.item()``, ``bool(...)``, a ``torch.*`` call) —
      in a function with no ``batch_mode`` gate.  The reference's vmapped
      ``lax.switch`` / ``lax.cond``: under vmap every instance pays every
      branch, or the branch reads one instance's value for all.
R003  An argument at a ``donate_argnums`` position of a ``stages.wrap``
      program referenced after the call without being rebound: the
      program may update it in place (``stages.wrap``'s donation), so the
      name no longer holds the state it held.
R004  A host escape inside a function wrapped with ``kind="graph"`` (or a
      function or lambda lexically inside one): ``.item()``,
      ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int(t)`` / ``bool(t)`` /
      ``float(t)`` on a possibly-tensor value, or ``print``.  A captured
      CUDA graph cannot read the host; the read runs once at capture and
      never at replay.  Static shape/dtype metadata is exempt.
R005  A raw-buffer reduction without the ``sorted`` / nnz gate (the
      reference's dirty-tail class): a function reduces values derived
      from a segment's ``.val`` buffer (``torch.sum`` and friends, the
      method forms ``x.sum()``, or ``index_add_`` / ``scatter_add`` /
      ``scatter_reduce`` of them) but never consults ``.nnz``, takes no
      ``sorted`` parameter and passes no ``sorted=`` keyword — it trusts
      the sentinel tail, which the raw-buffer contract does not promise.
R006  A kernel outside the registry: ``build.load``, ``ctypes.CDLL``,
      ``@triton.jit`` or ``torch.utils.cpp_extension.load*`` that names a
      source not in ``kernels/registry.py``'s ``AUDITED_FILES`` (read with
      stdlib ``ast``).  ``kernels/build.py`` is the registry's own loader;
      everywhere else a library or Triton kernel must be one that palkit
      audits and the parity tests pin against its plain version.

Suppression: append ``# reprolint: allow(R00x) <reason>`` to the line (or
the line directly above, for wrapped statements).  A suppression without
a reason does not suppress.  Pre-existing debt lives in a committed
baseline file (one ``RULE path scope`` entry per violation); it starts
and stays empty.  The lint exits non-zero only on violations that are
neither suppressed nor baselined.
"""
from __future__ import annotations

import argparse
import ast
import collections
import dataclasses
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import baseline as _baseline

RULES = {
    "R001": "capture/compile (torch.cuda.graph, torch.compile, torch.jit) "
            "outside stages.py (route through stages.wrap)",
    "R002": "vmap-reachable branch on a tensor value without a batch_mode "
            "gate",
    "R003": "donated argument referenced after the donating call",
    "R004": "host escape inside a captured (kind=\"graph\") function",
    "R005": "raw-buffer reduction without an nnz/sorted gate",
    "R006": "kernel library or Triton kernel outside the registry-audited "
            "kernel universe",
}

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "reprolint_baseline.txt")
PACKAGE = "repro_torch"

_ALLOW_RE = re.compile(r"#\s*reprolint:\s*allow\(([A-Za-z0-9, ]+)\)\s*(.*)$")

# Attribute names whose presence marks an expression as static metadata
# (safe to consume host-side even in captured code).
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "itemsize", "capacity",
                 "cuts", "num_layers", "name", "device", "is_cuda",
                 "element_size", "dim", "numel"}

_REDUCE_ATTRS = {"sum", "cumsum", "prod", "mean", "max", "min", "amax",
                 "amin", "segment_add", "segment_sum", "logsumexp"}
_SCATTER_ATTRS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                  "scatter_reduce", "scatter_reduce_"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    scope: str
    message: str

    @property
    def key(self) -> str:
        # Baseline identity is line-free so unrelated edits don't churn it.
        return f"{self.rule} {self.path} {self.scope}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} {self.message}"
                f" [in {self.scope}]")


def _norm_path(path: str) -> str:
    """Stable repo-relative identity: everything from the last
    ``repro_torch`` package component on, else the basename."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if PACKAGE in parts:
        i = len(parts) - 1 - parts[::-1].index(PACKAGE)
        return "/".join(parts[i:])
    return parts[-1]


# --------------------------------------------------------------- file model --


def _names_in(node: ast.AST) -> Set[str]:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.arg):
            out.add(n.arg)
    return out


def _attrs_in(node: ast.AST) -> Set[str]:
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _func_tail(func: ast.AST) -> Optional[str]:
    """Rightmost identifier of a call target: ``torch.cuda.graph`` ->
    ``graph``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class _File:
    """Parsed file plus the scope/parent indexes every rule shares."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.norm = _norm_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.allow: Dict[int, Tuple[Set[str], str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.allow[i] = (rules, m.group(2).strip())
        self._scope_names: Dict[ast.AST, Set[str]] = {}
        # module-level NAME = "string" constants (R006 resolves SOURCE)
        self.consts: Dict[str, str] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.consts[t.id] = node.value.value

    def scopes_of(self, node: ast.AST) -> List[ast.AST]:
        """Enclosing function scopes, innermost first."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def scope_name(self, node: ast.AST) -> str:
        parts = [getattr(s, "name", "<lambda>") for s in self.scopes_of(node)]
        return ".".join(reversed(parts)) or "<module>"

    def scope_mentions(self, scope: ast.AST, name: str) -> bool:
        if scope not in self._scope_names:
            self._scope_names[scope] = _names_in(scope)
        return name in self._scope_names[scope]

    def suppressed(self, v: Violation) -> bool:
        for line in (v.line, v.line - 1):
            entry = self.allow.get(line)
            if entry and v.rule in entry[0] and entry[1]:
                return True
        return False


# -------------------------------------------------------------------- rules --

# Every capture/compile spelling the front-door contract covers, by its
# dotted name, and the modules whose ``from`` imports alias them.
_R001_DOTTED = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                "torch.cuda.graphs.graph", "torch.cuda.graphs.CUDAGraph",
                "torch.cuda.make_graphed_callables",
                "torch.cuda.graphs.make_graphed_callables",
                "torch.compile", "torch.jit.script", "torch.jit.trace"}
_R001_FROM = {"torch": {"compile"},
              "torch.cuda": {"graph", "CUDAGraph",
                             "make_graphed_callables"},
              "torch.cuda.graphs": {"graph", "CUDAGraph",
                                    "make_graphed_callables"},
              "torch.jit": {"script", "trace"}}


def _r001(f: _File) -> Iterable[Violation]:
    if os.path.basename(f.path) == "stages.py":
        return
    aliases: Dict[str, str] = {}
    for node in ast.walk(f.tree):
        if isinstance(node, ast.ImportFrom) and node.module in _R001_FROM:
            for alias in node.names:
                if alias.name in _R001_FROM[node.module]:
                    aliases[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
    for node in ast.walk(f.tree):
        name = None
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if dotted in _R001_DOTTED:
                name = dotted
        elif isinstance(node, ast.Name) and node.id in aliases \
                and isinstance(node.ctx, ast.Load):
            name = aliases[node.id]
        if name is not None:
            yield Violation(
                "R001", f.norm, node.lineno, f.scope_name(node),
                f"bare {name}: production capture and compile route "
                "through repro_torch.stages.wrap (keyed cache, counted "
                "captures)")


def _tensor_test(test: ast.AST) -> bool:
    """An ``if``/``while`` test that reads a tensor value."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            tail = _func_tail(n.func)
            if tail in ("item", "any", "all") \
                    or (isinstance(n.func, ast.Name) and tail == "bool"):
                return True
            dotted = _dotted(n.func) or ""
            if dotted.startswith("torch."):
                return True
    return False


def _r002(f: _File) -> Iterable[Violation]:
    uses_vmap = any(
        (isinstance(n, ast.Name) and n.id == "vmap")
        or (isinstance(n, ast.Attribute) and n.attr == "vmap")
        for n in ast.walk(f.tree))
    if not uses_vmap:
        return
    for node in ast.walk(f.tree):
        what = None
        if isinstance(node, ast.Call) and _dotted(node.func) in (
                "torch.cond", "torch._higher_order_ops.cond"):
            what = "torch.cond"
        elif isinstance(node, (ast.If, ast.While)) \
                and _tensor_test(node.test) and f.scopes_of(node):
            what = "a branch on a tensor value"
        if what is None:
            continue
        gated = any(f.scope_mentions(s, "batch_mode")
                    for s in f.scopes_of(node))
        if not gated:
            yield Violation(
                "R002", f.norm, node.lineno, f.scope_name(node),
                f"{what} in a vmap-using module without a batch_mode "
                "gate: under vmap every instance pays every branch, or "
                "one instance's value picks the branch for all")


def _donation_positions(call: ast.Call) -> Optional[Tuple[int, ...]]:
    """donate_argnums positions when ``call`` builds a donating program
    (``stages.wrap`` or a partial-wrapped form), else None."""
    tail = _func_tail(call.func)
    if tail == "partial" and call.args \
            and isinstance(call.args[0], ast.Call):
        return _donation_positions(call.args[0])
    if tail != "wrap":
        return None
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            vals = kw.value.elts if isinstance(
                kw.value, (ast.Tuple, ast.List)) else [kw.value]
            return tuple(v.value for v in vals
                         if isinstance(v, ast.Constant)
                         and isinstance(v.value, int))
    return None


def _stmt_lists(root: ast.AST) -> Iterable[List[ast.stmt]]:
    for node in ast.walk(root):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list) and stmts \
                    and all(isinstance(s, ast.stmt) for s in stmts):
                yield stmts


def _assigned_names(stmt: ast.stmt) -> Set[str]:
    return {n.id for n in ast.walk(stmt)
            if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,
                                                              ast.Del))}


def _read_names(stmt: ast.stmt) -> Set[str]:
    return {n.id for n in ast.walk(stmt)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _r003(f: _File) -> Iterable[Violation]:
    donors: Dict[str, Tuple[int, ...]] = {}
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            pos = _donation_positions(node.value)
            if pos:
                donors[node.targets[0].id] = pos
    if not donors:
        return
    for stmts in _stmt_lists(f.tree):
        for i, stmt in enumerate(stmts):
            for call in ast.walk(stmt):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)
                        and call.func.id in donors):
                    continue
                rebound = _assigned_names(stmt)
                for pos in donors[call.func.id]:
                    if pos >= len(call.args):
                        continue
                    arg = call.args[pos]
                    if not isinstance(arg, ast.Name) or arg.id in rebound:
                        continue            # x = f(x): rebound by the call
                    for later in stmts[i + 1:]:
                        if arg.id in _read_names(later):
                            yield Violation(
                                "R003", f.norm, later.lineno,
                                f.scope_name(later),
                                f"'{arg.id}' read after being donated to "
                                f"'{call.func.id}' (donate_argnums "
                                f"position {pos}) — the program may have "
                                "updated it in place")
                            break
                        if arg.id in _assigned_names(later):
                            break


def _is_graph_wrap(call: ast.Call) -> bool:
    return _func_tail(call.func) == "wrap" and any(
        kw.arg == "kind" and isinstance(kw.value, ast.Constant)
        and kw.value.value == "graph" for kw in call.keywords)


def _captured_functions(f: _File) -> Set[ast.AST]:
    """Function nodes wrapped with ``kind="graph"`` (by name or as a
    lambda); functions lexically inside them count through scopes_of."""
    by_name: Dict[str, List[ast.AST]] = collections.defaultdict(list)
    for node in ast.walk(f.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name[node.name].append(node)
    out: Set[ast.AST] = set()
    for node in ast.walk(f.tree):
        if not (isinstance(node, ast.Call) and _is_graph_wrap(node)):
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Lambda):
            out.add(arg)
        elif isinstance(arg, ast.Name):
            out.update(by_name.get(arg.id, ()))
    return out


def _is_static_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            return True
        if isinstance(n, ast.Call) and _func_tail(n.func) == "len":
            return True
    return False


def _r004(f: _File) -> Iterable[Violation]:
    captured = _captured_functions(f)
    if not captured:
        return

    def in_captured(node: ast.AST) -> bool:
        return any(s in captured for s in f.scopes_of(node))

    def bound_outside(node: ast.AST, name: str) -> bool:
        """A Name bound entirely outside the captured region (a maker's
        static knob the captured body closes over) is static."""
        for s in f.scopes_of(node):
            args = s.args
            params = {a.arg for a in args.args + args.kwonlyargs}
            stores = {n.id for n in ast.walk(s)
                      if isinstance(n, ast.Name)
                      and isinstance(n.ctx, ast.Store)}
            if name in params or name in stores:
                return s not in captured \
                    and not any(t in captured for t in f.scopes_of(s))
        return True                     # module-level constant

    for node in ast.walk(f.tree):
        if not (isinstance(node, ast.Call) and in_captured(node)):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _HOST_METHODS \
                and not node.args:
            yield Violation(
                "R004", f.norm, node.lineno, f.scope_name(node),
                f".{func.attr}() inside a captured function reads the "
                "host: it runs once at capture and never at replay")
        elif isinstance(func, ast.Name) and func.id in ("int", "float",
                                                        "bool") \
                and node.args and not _is_static_expr(node.args[0]) \
                and not (isinstance(node.args[0], ast.Name)
                         and bound_outside(node, node.args[0].id)):
            yield Violation(
                "R004", f.norm, node.lineno, f.scope_name(node),
                f"{func.id}() on a possibly-tensor value inside a "
                "captured function (static shape/dtype metadata is "
                "exempt)")
        elif isinstance(func, ast.Name) and func.id == "print":
            yield Violation(
                "R004", f.norm, node.lineno, f.scope_name(node),
                "print inside a captured function: it runs at capture "
                "only, and printing a tensor reads the host")


def _reduction_input(node: ast.Call) -> Optional[ast.AST]:
    """The reduced operand of a reduction call, else None."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    base = func.value
    if func.attr in _REDUCE_ATTRS:
        if isinstance(base, ast.Name) and base.id in ("torch", "np",
                                                      "numpy", "sr"):
            return node.args[0] if node.args else None
        if isinstance(base, ast.Attribute) and _dotted(base) \
                and _dotted(base).startswith("torch."):
            return node.args[0] if node.args else None
        return base                                 # x.sum()
    if func.attr in _SCATTER_ATTRS:
        src = [kw.value for kw in node.keywords if kw.arg == "src"]
        return src[0] if src else (node.args[2] if len(node.args) > 2
                                   else None)
    return None


def _r005(f: _File) -> Iterable[Violation]:
    for fn in ast.walk(f.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        if "sorted" in params:
            continue                    # the gate is this function's job
        if "nnz" in _attrs_in(fn):
            continue                    # consults the live-slot count
        if any(kw.arg == "sorted" for n in ast.walk(fn)
               if isinstance(n, ast.Call) for kw in n.keywords):
            continue
        # Taint: names derived (transitively) from a segment's .val buffer.
        tainted: Set[str] = set()

        def val_tainted(expr: ast.AST) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Attribute) and n.attr == "val":
                    return True
                if isinstance(n, ast.Name) and n.id in tainted:
                    return True
            return False

        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        for _ in range(len(assigns) + 1):
            grew = False
            for a in assigns:
                for t in a.targets:
                    if isinstance(t, ast.Name) and t.id not in tainted \
                            and val_tainted(a.value):
                        tainted.add(t.id)
                        grew = True
            if not grew:
                break
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            operand = _reduction_input(node)
            if operand is not None and val_tainted(operand):
                yield Violation(
                    "R005", f.norm, node.lineno, f.scope_name(node),
                    "reduction over segment .val data with no .nnz gate, "
                    "no sorted parameter and no sorted= kwarg — trusts "
                    "the sentinel tail, which the raw-buffer contract "
                    "does not promise")


_REGISTRY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              os.pardir, "kernels", "registry.py")
_audited_cache: dict = {}


def audited_kernel_files(registry_path: str = None):
    """The ``AUDITED_FILES`` tuple from kernels/registry.py, read with
    stdlib ast so this lint never imports torch.  Returns ``None`` when
    the registry is absent or unparseable."""
    path = os.path.abspath(registry_path or _REGISTRY_PATH)
    if path in _audited_cache:
        return _audited_cache[path]
    files = None
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "AUDITED_FILES"
                            for t in node.targets) \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                files = frozenset(e.value for e in node.value.elts
                                  if isinstance(e, ast.Constant)
                                  and isinstance(e.value, str))
                break
    except OSError:
        pass
    _audited_cache[path] = files
    return files


def _source_named(f: _File, call: ast.Call) -> Optional[str]:
    """The source a loader call names: a string literal, or a module-level
    string constant (``SOURCE``), else None (not statically known)."""
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg in ("source", "sources")]
    for a in args:
        if isinstance(a, (ast.List, ast.Tuple)) and a.elts:
            a = a.elts[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
        if isinstance(a, ast.Name) and a.id in f.consts:
            return f.consts[a.id]
    return None


def _r006(f: _File) -> Iterable[Violation]:
    audited = audited_kernel_files() or frozenset()
    is_loader = f.norm == f"{PACKAGE}/kernels/build.py"
    rel = f.norm[len(f"{PACKAGE}/kernels/"):] \
        if f.norm.startswith(f"{PACKAGE}/kernels/") else None
    for node in ast.walk(f.tree):
        what = None
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            tail = _func_tail(node.func)
            if dotted in ("ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary"):
                if is_loader:
                    continue            # the registry's own loader
                what = "ctypes.CDLL"
                src = None
            elif dotted == "build.load" or (tail == "load" and "build"
                                            in dotted.split(".")[:-1]):
                what, src = "build.load", _source_named(f, node)
            elif "cpp_extension" in dotted or tail in ("load_inline",):
                what, src = dotted or tail, _source_named(f, node)
            else:
                continue
            if src is not None and src in audited:
                continue
            why = (f"{what} of {src!r}: not in kernels/registry.py's "
                   "AUDITED_FILES" if src else
                   f"{what} outside kernels/build.py loads a library "
                   "the registry does not name")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and any((_dotted(d.func if isinstance(d, ast.Call) else d)
                         or "").endswith("triton.jit")
                        for d in node.decorator_list):
            if rel is not None and rel in audited:
                continue
            what = "@triton.jit"
            why = (f"@triton.jit in {f.norm}, a file not in "
                   "kernels/registry.py's AUDITED_FILES")
        else:
            continue
        yield Violation(
            "R006", f.norm, node.lineno, f.scope_name(node),
            f"{why} — palkit never audits it and no parity job pins it "
            "against its plain version")


_RULE_FNS = (_r001, _r002, _r003, _r004, _r005, _r006)


# ----------------------------------------------------------- running --


def lint_source(source: str, path: str = "<string>",
                with_suppressed: bool = False) -> List[Violation]:
    """Lint one source blob.  Suppressed violations are dropped unless
    ``with_suppressed`` — the self-tests use both views."""
    f = _File(source, path)
    out: List[Violation] = []
    for rule in _RULE_FNS:
        for v in rule(f):
            if with_suppressed or not f.suppressed(v):
                out.append(v)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(paths: Sequence[str]) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            out.extend(lint_source(source, path))
        except SyntaxError as e:
            out.append(Violation("R000", _norm_path(path), e.lineno or 0,
                                 "<module>", f"syntax error: {e.msg}"))
    return out


load_baseline = _baseline.load_baseline

_BASELINE_HEADER = (
    "# reprolint baseline — accepted pre-existing debt, one\n"
    "# 'RULE path scope' entry per violation.  Regenerate with\n"
    "#   python -m repro_torch.analysis.lint src/repro_torch "
    "--write-baseline\n"
    "# New violations (keys not in this file) fail the lint.\n")


def write_baseline(path: str, violations: Sequence[Violation]) -> None:
    _baseline.write_baseline(path, violations, _BASELINE_HEADER)


def new_violations(violations: Sequence[Violation],
                   baseline: collections.Counter) -> List[Violation]:
    return _baseline.new_violations(violations, baseline)


def per_rule_counts(violations: Sequence[Violation]) -> Dict[str, int]:
    return _baseline.per_rule_counts(violations, RULES)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint: front-door + canonical-form contracts of "
                    "the port")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                    "src/repro_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: the committed one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every violation, ignore the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current violations as the new baseline")
    ap.add_argument("--check", action="store_true",
                    help="lint and exit 1 on new violations (the default)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="counts and verdict only, no per-line output")
    args = ap.parse_args(argv)

    violations = lint_paths(args.paths or ["src/repro_torch"])
    baseline = collections.Counter() if args.no_baseline \
        else load_baseline(args.baseline)
    fresh = new_violations(violations, baseline)

    if args.write_baseline:
        write_baseline(args.baseline, violations)
        print(f"baseline written: {len(violations)} entries -> "
              f"{args.baseline}")
        return 0

    if not args.quiet:
        for v in fresh:
            print(v.render())
    counts = per_rule_counts(violations)
    fresh_counts = per_rule_counts(fresh)
    print("reprolint per-rule counts (total / new):")
    for rule in sorted(counts):
        print(f"  {rule}: {counts[rule]} / {fresh_counts.get(rule, 0)}"
              f"  — {RULES.get(rule, 'internal')}")
    baselined = len(violations) - len(fresh)
    print(f"{len(violations)} violation(s), {baselined} baselined, "
          f"{len(fresh)} new")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
