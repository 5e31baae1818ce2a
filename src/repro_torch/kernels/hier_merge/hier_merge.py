"""Canonical-segment merge kernels — the paper's block-update op on Hopper.

Two kernels, hand-written in CUDA C++ for ``sm_90a``
(``csrc/hier_merge.cu``), replace the Pallas kernels of
``repro/kernels/hier_merge/hier_merge.py``:

``merge_multi_cuda``  one UNSORTED power-of-two block plus k canonical runs
                      (``merge_multi_pallas``): the fused spill cascade's
                      multi-way merge, the main path's kernel;
``merge_cuda``        two canonical segments (``merge_pallas``): the
                      layered oracle path's pairwise merge.

Both compute what the TPU kernels compute — the canonical segment of the
padded size N (live prefix sorted by signed lexicographic (hi, lo),
duplicates combined under the semiring, a (SENTINEL, SENTINEL, zero) tail)
plus ``nnz`` — in four phases:

  A  bitonic network: sort the block, then fold each run in with a bitonic
     merge of acc ++ reversed run (global-memory stages for strides of a
     tile or more, shared-memory tiles below);
  B  segmented inclusive scan over head flags: each run's last element
     ends up holding the run's semiring total;
  C  keep the run-last element of every run whose key is not SENTINEL;
  D  stable compaction by an exclusive prefix sum of the keep flags, then
     fill [nnz, N) with SENTINEL / zero.

Beside each wrapper is its plain PyTorch version (``merge_plain``,
``merge_multi_plain``), which runs the same phases with tensor ops: the
bitonic compare-exchange as ``reshape(rows, 2, stride)``, a segmented scan
and a cumsum-scatter compaction.  A wrapper runs the plain version for
tensors on the CPU and the CUDA kernel for tensors on the card; it never
falls back from one to the other.  Each CUDA launch adds one to the
wrapper's counter in ``kernels.registry.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.hier_merge.ref import SENTINEL, _as_tensor, _zero_for

SOURCE = "hier_merge/csrc/hier_merge.cu"

_COMBINE = {
    "plus.times": torch.add,
    "max.plus": torch.maximum,
    "max.min": torch.maximum,
    "min.plus": torch.minimum,
}

# the combine the CUDA side templates on: 0 add, 1 max, 2 min
_SR_KIND = {"plus.times": 0, "max.plus": 1, "max.min": 1, "min.plus": 2}


# ------------------------------------------------------------- plain path ---

def _lex_gt(hi_a, lo_a, hi_b, lo_b):
    return (hi_a > hi_b) | ((hi_a == hi_b) & (lo_a > lo_b))


def _compare_exchange(hi, lo, val, stride: int, k: int):
    """One compare-exchange stage over pairs (i, i + stride) of each
    2*stride block; a pair orders ascending iff bit ``k`` of its base index
    is 0 (``k`` >= n: every pair ascending, the merge stages)."""
    n = hi.shape[0]
    rows = n // (2 * stride)

    def pair(x):
        y = x.reshape(rows, 2, stride)
        return y[:, 0, :], y[:, 1, :]

    ha, hb = pair(hi)
    la, lb = pair(lo)
    va, vb = pair(val)
    base = torch.arange(rows, device=hi.device).unsqueeze(1) * (2 * stride)
    asc = (base & k) == 0
    swap = torch.where(asc, _lex_gt(ha, la, hb, lb), _lex_gt(hb, lb, ha, la))

    def sel(a, b):
        return torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                           dim=1).reshape(n)

    return sel(ha, hb), sel(la, lb), sel(va, vb)


def _bitonic_merge(hi, lo, val):
    """Sort a bitonic sequence ascending: strides N/2 .. 1."""
    n = hi.shape[0]
    stride = n // 2
    while stride >= 1:
        hi, lo, val = _compare_exchange(hi, lo, val, stride, n)
        stride //= 2
    return hi, lo, val


def _bitonic_sort(hi, lo, val):
    """Full bitonic sort (no pre-order assumed)."""
    n = hi.shape[0]
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            hi, lo, val = _compare_exchange(hi, lo, val, j, k)
            j //= 2
        k *= 2
    return hi, lo, val


def _combine_dedup_compact(hi, lo, val, sr_name: str):
    """Phases B-D on one sorted sequence: segmented inclusive scan (each
    run's last element holds the run total), keep the live run-last
    elements, compact them by an exclusive prefix sum, sentinel-fill."""
    combine = _COMBINE[sr_name]
    zero = _zero_for(sr_name, val.dtype)
    n = hi.shape[0]
    dev = hi.device

    head = torch.ones((n,), dtype=torch.bool, device=dev)
    head[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])

    # --- phase B: segmented inclusive scan over (head flag, value) ---------
    flag, acc = head, val
    d = 1
    while d < n:
        prev_f = torch.cat([torch.ones((d,), dtype=torch.bool, device=dev),
                            flag[:-d]])
        prev_v = torch.cat([torch.full((d,), zero, dtype=val.dtype,
                                       device=dev), acc[:-d]])
        acc = torch.where(flag, acc, combine(prev_v, acc))
        flag = flag | prev_f
        d *= 2

    # --- phases C-D: keep live run-last elements, compact, fill ------------
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = head[1:]
    keep = last & (hi != SENTINEL)
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    nnz = torch.sum(keep).to(torch.int32)

    def compact(x, fill):
        out = torch.full((n + 1,), fill, dtype=x.dtype, device=dev)
        return out.scatter(0, dest, x)[:n]

    return (compact(hi, SENTINEL), compact(lo, SENTINEL), compact(acc, zero),
            nnz.reshape(1))


def merge_plain(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *,
                sr_name: str = "plus.times"):
    """Plain version of ``merge_cuda``: bitonic merge of A ++ reverse(B),
    then combine/dedup/compact.  Returns (hi, lo, val, nnz[1])."""
    a = [_as_tensor(x) for x in (hi_a, lo_a, val_a)]
    b = [_as_tensor(x) for x in (hi_b, lo_b, val_b)]
    n = a[0].shape[0] + b[0].shape[0]
    assert n & (n - 1) == 0, f"total capacity must be a power of 2, got {n}"
    hi, lo, val = (torch.cat([x, torch.flip(y, (0,))]) for x, y in zip(a, b))
    hi, lo, val = _bitonic_merge(hi, lo, val)
    return _combine_dedup_compact(hi, lo, val, sr_name)


def merge_multi_plain(block, runs, *, sr_name: str = "plus.times"):
    """Plain version of ``merge_multi_cuda``: bitonic-sort the block, fold
    each run in by a bitonic merge of acc ++ reversed run, then
    combine/dedup/compact.  Returns (hi, lo, val, nnz[1])."""
    hi, lo, val = (_as_tensor(x) for x in block)
    size = hi.shape[0]
    assert size & (size - 1) == 0, f"block size must be a power of 2: {size}"
    hi, lo, val = _bitonic_sort(hi, lo, val)
    for run in runs:
        rhi, rlo, rval = (_as_tensor(x) for x in run)
        hi = torch.cat([hi, torch.flip(rhi, (0,))])
        lo = torch.cat([lo, torch.flip(rlo, (0,))])
        val = torch.cat([val, torch.flip(rval, (0,))])
        assert hi.shape[0] & (hi.shape[0] - 1) == 0, \
            f"cumulative size must stay a power of 2, got {hi.shape[0]}"
        hi, lo, val = _bitonic_merge(hi, lo, val)
    return _combine_dedup_compact(hi, lo, val, sr_name)


# -------------------------------------------------------------- CUDA path ---

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_BOUND = {}


def _lib():
    """The built kernel library with its C signatures declared."""
    if "lib" not in _BOUND:
        lib = build.load(SOURCE)
        lib.hm_scratch_words.argtypes = [_I]
        lib.hm_scratch_words.restype = _I
        lib.hm_merge_multi.argtypes = (
            [_PP, _PP, _PP, _PI, _I] + [_P] * 8 + [_I, _I, _I, _P])
        lib.hm_merge_multi.restype = _I
        lib.hm_merge.argtypes = (
            [_P, _P, _P, _I, _P, _P, _P, _I] + [_P] * 8 + [_I, _I, _I, _P])
        lib.hm_merge.restype = _I
        lib.hm_error_string.argtypes = [_I]
        lib.hm_error_string.restype = ctypes.c_char_p
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check_operands(srcs, what: str):
    hi0 = srcs[0][0]
    dev, vdtype = hi0.device, srcs[0][2].dtype
    if dev.type != "cuda":
        raise ValueError(f"{what}: operands must be CUDA tensors, got {dev}")
    if vdtype not in (torch.float32, torch.int32):
        raise TypeError(f"{what}: values must be float32 or int32, "
                        f"got {vdtype}")
    for hi, lo, val in srcs:
        for x, dt in ((hi, torch.int32), (lo, torch.int32), (val, vdtype)):
            if x.device != dev or x.dtype != dt or x.dim() != 1 \
                    or not x.is_contiguous() or x.shape != hi.shape:
                raise ValueError(
                    f"{what}: every operand must be a contiguous 1-D {dt} "
                    f"tensor on {dev} matching its run's length")


def _launch(what: str, counter: str, srcs, first_sorted: bool,
            sr_name: str):
    _check_operands(srcs, what)
    hi0, val0 = srcs[0][0], srcs[0][2]
    dev, vdtype = hi0.device, val0.dtype
    n = sum(s[0].shape[0] for s in srcs)
    lib = _lib()
    zero = _zero_for(sr_name, vdtype)
    is_int = int(vdtype == torch.int32)
    zero_bits = int(zero) if is_int else \
        struct.unpack("<i", struct.pack("<f", zero))[0]
    key = dict(dtype=torch.int32, device=dev)
    work = [torch.empty(n, **key), torch.empty(n, **key),
            torch.empty(n, dtype=vdtype, device=dev)]
    out = [torch.empty(n, **key), torch.empty(n, **key),
           torch.empty(n, dtype=vdtype, device=dev)]
    nnz = torch.empty(1, **key)
    scratch = torch.empty(max(lib.hm_scratch_words(n), 1), **key)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tail = [work[0].data_ptr(), work[1].data_ptr(), work[2].data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                nnz.data_ptr(), scratch.data_ptr(),
                _SR_KIND[sr_name], is_int, zero_bits, stream]
        if first_sorted:
            (ha, la, va), (hb, lb, vb) = srcs
            err = lib.hm_merge(ha.data_ptr(), la.data_ptr(), va.data_ptr(),
                               ha.shape[0], hb.data_ptr(), lb.data_ptr(),
                               vb.data_ptr(), hb.shape[0], *tail)
        else:
            k = len(srcs)
            ptrs = [(ctypes.c_void_p * k)(*[s[j].data_ptr() for s in srcs])
                    for j in range(3)]
            lens = (ctypes.c_int * k)(*[s[0].shape[0] for s in srcs])
            err = lib.hm_merge_multi(ptrs[0], ptrs[1], ptrs[2], lens, k,
                                     *tail)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({lib.hm_error_string(err).decode()})")
    registry.count(counter)
    return out[0], out[1], out[2], nnz


def _route(x) -> str:
    dev = x.device.type if isinstance(x, torch.Tensor) else "cpu"
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"hier_merge: unsupported device {dev}")
    return dev


def merge_cuda(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *,
               sr_name: str = "plus.times"):
    """Pairwise merge of two canonical segments whose total capacity is a
    power of two (ops.py pads); returns (hi, lo, val, nnz[1]).  CPU tensors
    run ``merge_plain``; CUDA tensors launch the kernel."""
    if _route(hi_a) == "cpu":
        return merge_plain(hi_a, lo_a, val_a, hi_b, lo_b, val_b,
                           sr_name=sr_name)
    n = hi_a.shape[0] + hi_b.shape[0]
    if n & (n - 1):
        raise ValueError(f"merge_cuda: total capacity must be a power of 2, "
                         f"got {n}")
    return _launch("merge_cuda", "hier_merge.merge",
                   [(hi_a, lo_a, val_a), (hi_b, lo_b, val_b)], True, sr_name)


def merge_multi_cuda(block, runs, *, sr_name: str = "plus.times"):
    """Multi-way merge: ``block`` is an (hi, lo, val) triple of an UNSORTED
    power-of-two-sized buffer; ``runs`` canonical (hi, lo, val) triples
    padded (ops.py) so every cumulative size block+run_1+..+run_i is a
    power of two.  Returns (hi, lo, val, nnz[1]) at the final size.  CPU
    tensors run ``merge_multi_plain``; CUDA tensors launch the kernel."""
    if _route(block[0]) == "cpu":
        return merge_multi_plain(block, runs, sr_name=sr_name)
    size = block[0].shape[0]
    sizes = [size]
    for r in runs:
        size += r[0].shape[0]
        sizes.append(size)
    if any(s & (s - 1) for s in sizes):
        raise ValueError(f"merge_multi_cuda: cumulative sizes must be powers "
                         f"of 2, got {sizes}")
    return _launch("merge_multi_cuda", "hier_merge.merge_multi",
                   [tuple(block)] + [tuple(r) for r in runs], False, sr_name)

