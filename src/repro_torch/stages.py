"""Config signatures — the knob layer every entry point validates through.

A ``Signature`` is the canonical, hashable form of every knob that changes
what an entry point runs (cuts, block_size, dtype, semiring, fused /
lazy_l0 / use_kernel / chunk, batch_mode, query l0_mode, the mesh and data
axes of the sharded fleet functions, entry-specific ``extra`` knobs).
``signature_of`` is the single validator: an invalid combination fails
with the same ``invalid d4m config signature: ...`` message at every entry
point, as in the JAX package.  The port runs eagerly, so there is no
compile cache here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

# Canonical knob domains — stream.py re-exports BATCH_MODES from here so
# there is exactly one source of truth for the allowed values.
BATCH_MODES = ("grouped", "bucketed", "branchfree", "switch")
L0_MODES = ("auto", "scan", "canon")


@dataclasses.dataclass(frozen=True)
class Signature:
    """Canonical, hashable config signature.

    ``None`` fields mean "not pinned by this entry point".  ``mesh`` is
    the ``((axis name, size), ...)`` form of a ``launch.mesh.FleetMesh``
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
    name = np.dtype(dtype).name
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return name


def signature_of(*, cuts=None, block_size=None, dtype="float32", sr=None,
                 fused=True, lazy_l0=False, use_kernel=False, chunk=1,
                 batch_mode=None, mesh=None, data_axes=None, l0_mode=None,
                 extra=(),
                 allowed_batch_modes: Optional[Tuple[str, ...]] = None
                 ) -> Signature:
    """Canonicalize + validate a knob set into a ``Signature``.

    Bad cuts, unknown semirings/dtypes, ``lazy_l0`` outside plus.times,
    batch modes outside ``allowed_batch_modes`` (default: all of
    ``BATCH_MODES``), and ``data_axes`` that are not distinct axes of
    ``mesh`` (a ``FleetMesh`` or its ``((name, size), ...)`` form) all
    raise the same ``invalid d4m config signature: ...`` ValueError at
    every entry point.
    """
    fused, lazy_l0, use_kernel = bool(fused), bool(lazy_l0), bool(use_kernel)
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
