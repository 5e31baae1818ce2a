"""Public wrapper for the hier_merge kernels.

Chooses the route by the JAX package's size rule, slices or pads the
result to the destination layer capacity, and accounts overflow; the kernel
wrappers in ``hier_merge.py`` take operands of any length (no padding here)
and pick the CUDA kernel or its plain version by the operands' device.
Everything stays on the operands' device: no host synchronisation.

The kernel ceiling is the JAX package's: a merge takes the kernel iff its
power-of-two padded width (the TPU's bitonic rule, ``multi_padded_capacity``)
is at most ``MAX_KERNEL_CAPACITY`` = 64K entries, although the CUDA kernel
itself has no such limit.  Larger merges take the sort route
(``assoc._canonicalize`` reaches them first on the hierarchy's paths; called
directly, this module sends them to the sort-based oracle).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hier_merge import ref
from repro_torch.kernels.hier_merge.hier_merge import (merge_cuda,
                                                       merge_multi_cuda)
from repro_torch.kernels.hier_merge.ref import _next_pow2, _pad_canonical

MAX_KERNEL_CAPACITY = 1 << 16


def multi_padded_capacity(block_cap: int, run_caps) -> int:
    """The JAX package's in-kernel sequence size for a multi-way merge: the
    block padded to a power of two, then each run padded so every cumulative
    size stays a power of two (the TPU's bitonic-stage requirement).  The
    route rule compares it against MAX_KERNEL_CAPACITY."""
    cum = _next_pow2(max(block_cap, 1))
    for c in run_caps:
        cum = _next_pow2(cum + c)
    return cum


def _finalize(hi, lo, val, nnz, out_capacity: int, zero):
    """Pad or truncate a canonical merge result to ``out_capacity`` and
    account truncated unique entries as overflow."""
    nnz = nnz.reshape(())
    if out_capacity >= hi.shape[0]:
        hi, lo, val = _pad_canonical(hi, lo, val, out_capacity, zero)
        overflow = torch.zeros((), dtype=torch.int32, device=hi.device)
    else:
        hi, lo, val = hi[:out_capacity], lo[:out_capacity], val[:out_capacity]
        overflow = torch.clamp(nnz - out_capacity, min=0).to(torch.int32)
    return hi, lo, val, torch.clamp(nnz, max=out_capacity), overflow


def merge(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *, out_capacity: int,
          sr_name: str = "plus.times", use_kernel: bool = True):
    """Merge canonical segments a (+) b into a canonical segment of
    ``out_capacity``; returns (hi, lo, val, nnz, overflow)."""
    total = hi_a.shape[0] + hi_b.shape[0]
    n = _next_pow2(total)
    zero = ref._zero_for(sr_name, val_a.dtype)

    if use_kernel and n <= MAX_KERNEL_CAPACITY:
        hi, lo, val, nnz = merge_cuda(
            *(x.contiguous() for x in (hi_a, lo_a, val_a, hi_b, lo_b, val_b)),
            sr_name=sr_name)
    else:
        hi, lo, val, nnz = ref.merge_ref(hi_a, lo_a, val_a, hi_b, lo_b, val_b,
                                         sr_name=sr_name)
    return _finalize(hi, lo, val, nnz, out_capacity, zero)


def merge_multi(block_hi, block_lo, block_val, *run_arrays,
                out_capacity: int, sr_name: str = "plus.times",
                use_kernel: bool = True):
    """Multi-way merge: one unsorted COO buffer + k canonical sorted runs
    (passed flattened as hi_1, lo_1, val_1, hi_2, ...) into a canonical
    segment of ``out_capacity``; returns (hi, lo, val, nnz, overflow).

    This is the fused spill cascade's kernel entry point: below the ceiling
    the whole chain runs as ONE kernel call that sorts only the block and
    merges the sorted runs in; above it, one sort canonicalizes
    everything."""
    if len(run_arrays) % 3:
        raise ValueError("runs must be (hi, lo, val) triples")
    runs = [tuple(run_arrays[i:i + 3]) for i in range(0, len(run_arrays), 3)]
    zero = ref._zero_for(sr_name, block_val.dtype)
    padded = multi_padded_capacity(block_hi.shape[0],
                                   [r[0].shape[0] for r in runs])

    if use_kernel and padded <= MAX_KERNEL_CAPACITY:
        hi, lo, val, nnz = merge_multi_cuda(
            (block_hi.contiguous(), block_lo.contiguous(),
             block_val.contiguous()),
            [tuple(x.contiguous() for x in r) for r in runs], sr_name=sr_name)
    else:
        hi, lo, val, nnz = ref.merge_multi_ref(
            [block_hi] + [r[0] for r in runs],
            [block_lo] + [r[1] for r in runs],
            [block_val] + [r[2] for r in runs], sr_name=sr_name)
    return _finalize(hi, lo, val, nnz, out_capacity, zero)
