"""Runtime contract sanitizer: eager checks of the invariants the whole
hierarchy trades on (the CONTRACTS section of ``core/assoc.py``).

The canonical-form contract is what lets thousands of share-nothing
instances merge, query and checkpoint without coordination; a path that
silently breaks it corrupts every later merge.  These checks turn the
contract into executable assertions:

    check_canonical(seg, sr)      entries [0, nnz) sorted-unique by
                                  (hi, lo); slots [nnz, C) exactly
                                  SENTINEL + the semiring zero; nnz <= C.
                                  ``sorted=False`` checks the weaker
                                  RAW-buffer contract (bounds + clean
                                  sentinel tail, no ordering claim).
    check_counter(h)              the int64 update counter: non-negative
                                  (the reference's carry word), and total
                                  live slots never exceed it.
    check_plan(depths, cuts)      planned spill depths inside [0, L).
    check_hier(h, sr)             whole-state check: every layer + the
                                  counter.

The port runs eagerly, so a check needs no checkify: it reduces its
conditions on the device to a few booleans and reads them to the host
once (one synchronize per check), raising ``ContractViolation`` with the
reference's message, word for word, for the first one that fails.  All
checks broadcast over leading instance axes.

Activation: ``REPRO_CHECK=1`` (or an explicit ``debug=True`` to
``enabled``) makes the front doors — ``hier.update`` / ``hier.flush``,
``stream.update_instances`` / ``ingest_instances``, the
``query.engine`` queries, ``checkpoint.restore`` — check their input
state before and their output state after, and every ``assoc.merge_many``
inside them its runs and result (``activate``).  The checked build keys
its own ``stages`` entry: its signature carries ``DEBUG_EXTRA``
(``debug_signature``), and that entry is always eager, because a check
reads the host.  With the knob off the front doors dispatch the
production key and run no check: no device operation and no host read.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import List, Optional, Tuple

import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.core.semiring import Semiring

# Mirrors assoc.SENTINEL; kept local so assoc can import this module
# without a cycle.
SENTINEL = 2**31 - 1

ENV_VAR = "REPRO_CHECK"

# Appended to Signature.extra by the checked front doors: the checked
# build keys a separate stages cache entry.
DEBUG_EXTRA: Tuple[Tuple[str, bool], ...] = (("debug", True),)

_ACTIVE = threading.local()


class ContractViolation(RuntimeError):
    """A state broke the canonical-form, counter or plan contract."""


def enabled(debug: Optional[bool] = None) -> bool:
    """The sanitizer knob: an explicit ``debug`` argument wins, otherwise
    ``REPRO_CHECK`` (unset/empty/"0" mean off)."""
    if debug is not None:
        return bool(debug)
    return os.environ.get(ENV_VAR, "") not in ("", "0")


def sig_debug(sig) -> bool:
    """True when a ``stages.Signature`` carries the debug knob."""
    return ("debug", True) in tuple(sig.extra)


def debug_signature(sig):
    """The signature's checked twin (idempotent)."""
    import dataclasses
    if sig_debug(sig):
        return sig
    return dataclasses.replace(sig, extra=tuple(sig.extra) + DEBUG_EXTRA)


def front_door_signature(sig):
    """``sig``, or its checked twin when the knob is on: the key a front
    door dispatches."""
    return debug_signature(sig) if enabled() else sig


def deep_checks_active() -> bool:
    """True inside an ``activate()`` region: the flag ``assoc.merge_many``
    consults so intermediate results are checked without threading a
    debug argument through the cascade."""
    return getattr(_ACTIVE, "on", False)


@contextlib.contextmanager
def activate():
    prev = getattr(_ACTIVE, "on", False)
    _ACTIVE.on = True
    try:
        yield
    finally:
        _ACTIVE.on = prev


Flags = List[Tuple[torch.Tensor, str]]


def _raise_first(flags: Flags) -> None:
    """One host read of every condition; raise the first that fails."""
    if not flags:
        return
    ok = torch.stack([torch.all(f).reshape(()) for f, _ in flags]).tolist()
    for good, (_, msg) in zip(ok, flags):
        if not good:
            raise ContractViolation(msg)


# ------------------------------------------------------------------ checks --

def _canonical_flags(seg, sr: Semiring, name: str, sorted: bool) -> Flags:
    hi, lo, val = seg.hi, seg.lo, seg.val
    C = hi.shape[-1]
    slot = torch.arange(C, device=hi.device)
    nnz = seg.nnz.unsqueeze(-1)
    live = slot < nnz
    zero = sr_mod.integer_zero(sr, val.dtype)
    flags = [
        ((seg.nnz >= 0) & (seg.nnz <= C),
         f"nnz bound violation in {name}: nnz outside [0, capacity]"),
        (live | ((hi == SENTINEL) & (lo == SENTINEL) & (val == zero)),
         f"sentinel-tail violation in {name}: slots [nnz, C) must hold the "
         "SENTINEL key and the semiring zero")]
    if sorted:
        flags.append(
            (~live | ((hi != SENTINEL) & (lo != SENTINEL)),
             f"canonical-form violation in {name}: SENTINEL key inside the "
             "live prefix [0, nnz)"))
        up = (hi[..., 1:] > hi[..., :-1]) \
            | ((hi[..., 1:] == hi[..., :-1]) & (lo[..., 1:] > lo[..., :-1]))
        flags.append(
            (~(slot[1:] < nnz) | up,
             f"canonical-form violation in {name}: entries [0, nnz) not "
             "sorted-unique by (hi, lo)"))
    return flags


def _counter_flags(h, name: str) -> Flags:
    if h.n_updates.dtype != torch.int64:
        raise TypeError(
            f"counter word dtype violation in {name}: expected an int64 "
            f"counter (the (uint32 lo, int32 hi) words in one), got "
            f"{h.n_updates.dtype}")
    slots = sum(l.nnz.to(torch.int64) for l in h.layers)
    return [(h.n_updates >= 0,
             f"counter carry violation in {name}: high word negative"),
            (slots <= h.n_updates,
             f"counter consistency violation in {name}: live slots exceed "
             "the (hi, lo) raw-update total")]


def check_canonical(seg, sr: Semiring = sr_mod.PLUS_TIMES,
                    name: str = "segment", sorted: bool = True) -> None:
    """Assert one segment (or a batch of them) upholds its buffer contract.

    ``sorted=True`` asserts full canonical form; ``sorted=False`` asserts
    the weaker raw-buffer contract a lazy layer-0 append buffer upholds
    (nnz bound + sentinel-clean tail — entries [0, nnz) may be unsorted
    and duplicated).  A canonical segment passes the raw check, so
    ``sorted=False`` is always safe when the discipline is unknown.
    """
    _raise_first(_canonical_flags(seg, sr, name, sorted))


def check_counter(h, name: str = "hier") -> None:
    """The update counter: never negative (the reference's carry word
    counts 2**32 wraps), and every live slot was deposited by at least one
    raw update, so the slot total never exceeds it."""
    _raise_first(_counter_flags(h, name))


def check_plan(depths, cuts, name: str = "plan") -> None:
    """Spill-plan bounds: every planned destination inside [0, L)."""
    L = len(tuple(cuts))
    d = torch.as_tensor(depths)
    _raise_first([((d >= 0) & (d < L),
                   f"spill-plan bound violation in {name}: planned depth "
                   f"outside [0, {L})")])


def check_hier(h, sr: Semiring = sr_mod.PLUS_TIMES,
               l0_sorted: bool = True, name: str = "hier") -> None:
    """Whole-state check: every layer's buffer contract plus the counter,
    in one host read.  ``l0_sorted=False`` checks layer 0 against the
    raw-buffer contract (lazy append discipline, or unknown provenance —
    e.g. a restored checkpoint); deeper layers are always canonical."""
    flags = []
    for i, layer in enumerate(h.layers):
        flags += _canonical_flags(layer, sr, f"{name} layer {i}",
                                  (i > 0) or l0_sorted)
    _raise_first(flags + _counter_flags(h, name))


def checked(name: str, h, sr: Semiring, run, l0_sorted: bool,
            out_l0_sorted: Optional[bool] = None):
    """The checked build of a front door's ``run()`` (the body of a
    ``DEBUG_EXTRA`` entry): ``h`` checked first (layer 0 as a raw buffer
    unless ``l0_sorted``), every merge inside deep-checked, and the result
    — when it is a state, or a tuple led by one — checked after (layer 0
    by ``out_l0_sorted``, default ``l0_sorted``)."""
    check_hier(h, sr, l0_sorted=l0_sorted, name=f"{name} input")
    with activate():
        out = run()
    state = out[0] if isinstance(out, tuple) else out
    if hasattr(state, "layers"):
        check_hier(state, sr, name=f"{name} output",
                   l0_sorted=l0_sorted if out_l0_sorted is None
                   else out_l0_sorted)
    return out


# ----------------------------------------------------- eager validation -----

def validate_segment(seg, sr: Semiring = sr_mod.PLUS_TIMES,
                     name: str = "segment", sorted: bool = True) -> None:
    """``check_canonical`` under the reference's name."""
    check_canonical(seg, sr, name=name, sorted=sorted)


def validate_hier(h, sr: Semiring = sr_mod.PLUS_TIMES,
                  l0_sorted: bool = False, name: str = "hier") -> None:
    """``check_hier`` with layer 0 held to the raw-buffer contract by
    default, because the caller usually cannot know the append discipline
    (checkpoint restore)."""
    check_hier(h, sr, l0_sorted=l0_sorted, name=name)


def validate_restored(tree, sr: Semiring = sr_mod.PLUS_TIMES,
                      name: str = "restore") -> None:
    """Walk a restored tree and validate every associative-array state in
    it: ``HierAssoc``-shaped nodes get the whole-state check (layer 0
    against the raw contract — restore cannot know the append
    discipline), free-standing segments get the raw-buffer check.

    Uses duck typing (``layers``/``n_updates``/``cuts`` attrs,
    ``hi``/``lo``/``val``/``nnz`` attrs) so the checkpoint layer does not
    need to import core types for its template trees.
    """
    seen = set()

    def is_hier(x):
        return hasattr(x, "layers") and hasattr(x, "n_updates") \
            and hasattr(x, "cuts")

    def is_seg(x):
        return all(hasattr(x, a) for a in ("hi", "lo", "val", "nnz"))

    def visit(node, label):
        if id(node) in seen:
            return
        seen.add(id(node))
        if is_hier(node):
            validate_hier(node, sr, l0_sorted=False, name=label)
            return
        if is_seg(node):
            validate_segment(node, sr, name=label, sorted=False)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{label}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, f"{label}[{i}]")
        elif hasattr(node, "__dataclass_fields__"):
            for k in node.__dataclass_fields__:
                visit(getattr(node, k), f"{label}.{k}")

    visit(tree, name)
