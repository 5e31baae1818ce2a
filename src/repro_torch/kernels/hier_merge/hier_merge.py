"""Canonical-segment merge kernels — the paper's block-update op on Hopper.

Two kernels, hand-written in CUDA C++ for ``sm_90a``
(``csrc/hier_merge.cu``), replace the Pallas kernels of
``repro/kernels/hier_merge/hier_merge.py``:

``merge_multi_cuda``  one UNSORTED block plus k canonical runs
                      (``merge_multi_pallas``): the fused spill cascade's
                      multi-way merge, the main path's kernel;
``merge_cuda``        two canonical segments (``merge_pallas``): the
                      layered oracle path's pairwise merge.

Both compute what the TPU kernels compute — the canonical segment (live
prefix sorted by signed lexicographic (hi, lo), duplicates combined under
the semiring, a (SENTINEL, SENTINEL, zero) tail) plus ``nnz`` — for values
of float32, int32, float16 or bfloat16 (the TPU kernels take any dtype and
combine in it; a 16-bit add rounds to 16 bits) and operands of any length,
at the summed input length, up to ``MAX_SORTED_OPERANDS`` sorted operands:
the block's ``RANK_CHUNK``-entry chunks plus the runs (a block of at most
1,048,576 entries; each chunk past the first adds a merge pass over the
growing prefix, so a block's cost rises with the square of its chunks).
On the card the block is rank-sorted across CTAs, then merge-path CTAs
merge, combine and compact in one pass with a decoupled look-back (two
launches at k = 1; the source note in ``csrc/hier_merge.cu`` has the
design).

Beside each wrapper is its plain PyTorch version (``merge_plain``,
``merge_multi_plain``), which pads to powers of two with sentinels and runs
the TPU kernels' phases with tensor ops: the bitonic compare-exchange as
``reshape(rows, 2, stride)``, a segmented scan and a cumsum-scatter
compaction, then slices back.  A wrapper runs the plain version for tensors
on the CPU and the CUDA kernel for tensors on the card; it never falls back
from one to the other.  Each CUDA launch adds one to the wrapper's counter
in ``kernels.registry.LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.hier_merge.ref import (SENTINEL, _as_tensor,
                                                _next_pow2, _pad_canonical,
                                                _zero_for)

SOURCE = "hier_merge/csrc/hier_merge.cu"

_COMBINE = {
    "plus.times": torch.add,
    "max.plus": torch.maximum,
    "max.min": torch.maximum,
    "min.plus": torch.minimum,
}

# the combine the CUDA side templates on: 0 add, 1 max, 2 min
_SR_KIND = {"plus.times": 0, "max.plus": 1, "max.min": 1, "min.plus": 2}

# the value types the CUDA side takes, by its code for them
_VTYPE = {torch.float32: 0, torch.int32: 1, torch.float16: 2,
          torch.bfloat16: 3}


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
    """Plain version of ``merge_cuda``: B padded so the total is a power of
    two, bitonic merge of A ++ reverse(B), combine/dedup/compact, sliced
    back to the summed length.  Returns (hi, lo, val, nnz[1])."""
    a = [_as_tensor(x) for x in (hi_a, lo_a, val_a)]
    b = [_as_tensor(x) for x in (hi_b, lo_b, val_b)]
    n = a[0].shape[0] + b[0].shape[0]
    b = _pad_canonical(*b, _next_pow2(n) - a[0].shape[0],
                       _zero_for(sr_name, b[2].dtype))
    hi, lo, val = (torch.cat([x, torch.flip(y, (0,))]) for x, y in zip(a, b))
    hi, lo, val = _bitonic_merge(hi, lo, val)
    out = _combine_dedup_compact(hi, lo, val, sr_name)
    return out[0][:n], out[1][:n], out[2][:n], out[3]


def merge_multi_plain(block, runs, *, sr_name: str = "plus.times"):
    """Plain version of ``merge_multi_cuda``: the block padded to a power of
    two and bitonic-sorted, each run padded so every cumulative size is a
    power of two and folded in by a bitonic merge of acc ++ reversed run,
    then combine/dedup/compact, sliced back to the summed length.  Returns
    (hi, lo, val, nnz[1])."""
    hi, lo, val = (_as_tensor(x) for x in block)
    zero = _zero_for(sr_name, val.dtype)
    n = hi.shape[0]
    hi, lo, val = _bitonic_sort(*_pad_canonical(hi, lo, val, _next_pow2(n),
                                                zero))
    for run in runs:
        rhi, rlo, rval = (_as_tensor(x) for x in run)
        n += rhi.shape[0]
        rhi, rlo, rval = _pad_canonical(
            rhi, rlo, rval, _next_pow2(hi.shape[0] + rhi.shape[0])
            - hi.shape[0], zero)
        hi = torch.cat([hi, torch.flip(rhi, (0,))])
        lo = torch.cat([lo, torch.flip(rlo, (0,))])
        val = torch.cat([val, torch.flip(rval, (0,))])
        hi, lo, val = _bitonic_merge(hi, lo, val)
    out = _combine_dedup_compact(hi, lo, val, sr_name)
    return out[0][:n], out[1][:n], out[2][:n], out[3]


# -------------------------------------------------------------- CUDA path ---

# the C side's limits (csrc/hier_merge.cu: kMaxTotal, kRankCap, kMaxOperands)
MAX_ENTRIES = (1 << 29) - 1   # keep counts fill 29 bits of a tile's status
RANK_CHUNK = 4096             # entries of one rank-sorted chunk of the block
MAX_SORTED_OPERANDS = 256     # the block's chunks plus the non-empty runs
_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND = {}
_SCRATCH_WORDS = {}   # (block length, total, sorted operands) -> int32 words
_ZERO_BITS = {}       # (semiring, value dtype) -> the zero's bits


def _lib():
    """The built kernel library with its C signatures declared."""
    if "lib" not in _BOUND:
        lib = build.load(SOURCE)
        lib.hm_scratch_words.argtypes = [_I, _I, _I]
        lib.hm_scratch_words.restype = ctypes.c_longlong
        lib.hm_merge_multi.argtypes = [ctypes.POINTER(_P),
                                       ctypes.POINTER(_I), _I, _P, _P, _I,
                                       _I, _I, _P]
        lib.hm_merge_multi.restype = _I
        lib.hm_merge.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                                 _I, _I, _P]
        lib.hm_merge.restype = _I
        lib.hm_error_string.argtypes = [_I]
        lib.hm_error_string.restype = ctypes.c_char_p
        lib.hm_launch_config.argtypes = [ctypes.POINTER(_I), _I, _I, _I, _I,
                                         ctypes.POINTER(_I), _I]
        lib.hm_launch_config.restype = _I
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check_operands(srcs, what: str, block_unsorted: bool) -> int:
    """The checks a launch needs, before anything is built or launched:
    every operand a contiguous 1-D tensor on the first one's device, keys
    int32, values of one type among float32, int32, float16 and bfloat16,
    hi/lo/val of a run of one length, the total at most ``MAX_ENTRIES``, at
    most ``MAX_SORTED_OPERANDS`` sorted operands (the unsorted block's chunks
    of ``RANK_CHUNK`` plus the non-empty runs).  Returns the total."""
    dev, vdtype = srcs[0][0].device, srcs[0][2].dtype
    if vdtype not in _VTYPE:
        raise TypeError(f"{what}: values must be float32, int32, float16 "
                        f"or bfloat16, got {vdtype}")
    total = 0
    for hi, lo, val in srcs:
        for x, dt in ((hi, torch.int32), (lo, torch.int32), (val, vdtype)):
            if x.device != dev or x.dtype != dt or x.dim() != 1 \
                    or not x.is_contiguous() or x.shape != hi.shape:
                raise ValueError(
                    f"{what}: every operand must be a contiguous 1-D {dt} "
                    f"tensor on {dev} matching its run's length")
        total += hi.shape[0]
    if total > MAX_ENTRIES:
        raise ValueError(f"{what}: {total} entries, at most {MAX_ENTRIES}")
    runs = srcs[1:] if block_unsorted else srcs
    chunks = -(-srcs[0][0].shape[0] // RANK_CHUNK) if block_unsorted else 0
    n_sorted = chunks + sum(1 for r in runs if r[0].shape[0])
    if n_sorted > MAX_SORTED_OPERANDS:
        raise ValueError(
            f"{what}: {chunks} block chunks of {RANK_CHUNK} and "
            f"{n_sorted - chunks} non-empty runs make {n_sorted} sorted "
            f"operands, at most {MAX_SORTED_OPERANDS}")
    return total


def _zero_bits(sr_name: str, vdtype) -> int:
    """The semiring zero's bit pattern in ``vdtype`` as a signed int (the
    C side keeps its low 32 or 16 bits): -inf / +inf for the float types,
    the integer min / max for int32."""
    key = (sr_name, vdtype)
    if key not in _ZERO_BITS:
        zero = torch.tensor([_zero_for(sr_name, vdtype)], dtype=vdtype)
        word = torch.int32 if zero.element_size() == 4 else torch.int16
        _ZERO_BITS[key] = int(zero.view(word)[0])
    return _ZERO_BITS[key]


def _scratch_words(lib, block_len: int, total: int, n_sorted: int) -> int:
    key = (block_len, total, n_sorted)
    if key not in _SCRATCH_WORDS:
        _SCRATCH_WORDS[key] = lib.hm_scratch_words(block_len, total, n_sorted)
    return _SCRATCH_WORDS[key]


def _launch(what: str, counter: str, srcs, block_unsorted: bool,
            sr_name: str):
    """One ctypes call on the current stream: the outputs and nnz are one
    allocation (hi, lo, nnz as int32 words, then the values in their own
    width), returned as views; the kernels' scratch (look-back state,
    sorted block, fold buffers) is a second one, handed back to the caching
    allocator on return (stream-ordered, so only work enqueued after this
    call reuses it)."""
    n = _check_operands(srcs, what, block_unsorted)
    dev, vdtype = srcs[0][0].device, srcs[0][2].dtype
    lib = _lib()
    block_len = srcs[0][0].shape[0] if block_unsorted else 0
    n_sorted = len(srcs) - 1 if block_unsorted else len(srcs)
    val_words = -(-n * torch.empty((), dtype=vdtype).element_size() // 4)
    out = torch.empty(2 * n + 1 + val_words, dtype=torch.int32, device=dev)
    scratch = torch.empty(_scratch_words(lib, block_len, n, n_sorted),
                          dtype=torch.int32, device=dev)
    args = (out.data_ptr(), scratch.data_ptr(), _SR_KIND[sr_name],
            _VTYPE[vdtype], _zero_bits(sr_name, vdtype),
            torch.cuda.current_stream(dev).cuda_stream)
    if block_unsorted:
        k = len(srcs)
        ptrs = (_P * (3 * k))(*[x.data_ptr() for s in srcs for x in s])
        lens = (_I * k)(*[s[0].shape[0] for s in srcs])
        call = lambda: lib.hm_merge_multi(ptrs, lens, k, *args)  # noqa: E731
    else:
        (ha, la, va), (hb, lb, vb) = srcs
        call = lambda: lib.hm_merge(  # noqa: E731
            ha.data_ptr(), la.data_ptr(), va.data_ptr(), ha.shape[0],
            hb.data_ptr(), lb.data_ptr(), vb.data_ptr(), hb.shape[0], *args)
    if dev.index == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(dev):
            err = call()
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({lib.hm_error_string(err).decode()})")
    # read and written once: (hi, lo, val) of every entry in, out, and nnz
    entry = 8 + torch.empty((), dtype=vdtype).element_size()
    registry.count(counter, 2 * n * entry + 4)
    return (out[:n], out[n:2 * n], out[2 * n + 1:].view(vdtype)[:n],
            out[2 * n:2 * n + 1])


def _launch_config(srcs, block_unsorted: bool, sr_name: str) -> list:
    """The launches ``_launch`` makes for these operands, as the C side
    decides them (``hm_launch_config``: a dry run of the same routine)."""
    _check_operands(srcs, "launch_config", block_unsorted)
    lib = _lib()
    lens = (_I * len(srcs))(*[s[0].shape[0] for s in srcs])
    rows = (_I * (4 * build.MAX_LAUNCHES))()
    n = lib.hm_launch_config(lens, len(srcs), 0 if block_unsorted else 1,
                             _SR_KIND[sr_name], _VTYPE[srcs[0][2].dtype],
                             rows, build.MAX_LAUNCHES)
    return build.launch_rows("hm", n, rows)


def merge_launch_config(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *,
                        sr_name: str = "plus.times") -> list:
    """``merge_cuda``'s launches for these operands (palkit)."""
    return _launch_config([(hi_a, lo_a, val_a), (hi_b, lo_b, val_b)], False,
                          sr_name)


def merge_multi_launch_config(block, runs, *,
                              sr_name: str = "plus.times") -> list:
    """``merge_multi_cuda``'s launches for these operands (palkit)."""
    return _launch_config([tuple(block)] + [tuple(r) for r in runs], True,
                          sr_name)


def _route(x) -> str:
    dev = x.device.type if isinstance(x, torch.Tensor) else "cpu"
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"hier_merge: unsupported device {dev}")
    return dev


def merge_cuda(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *,
               sr_name: str = "plus.times"):
    """Pairwise merge of two canonical segments of any lengths; returns
    (hi, lo, val, nnz[1]) at the summed length.  CPU tensors run
    ``merge_plain``; CUDA tensors launch the kernel."""
    if _route(hi_a) == "cpu":
        return merge_plain(hi_a, lo_a, val_a, hi_b, lo_b, val_b,
                           sr_name=sr_name)
    return _launch("merge_cuda", "hier_merge.merge",
                   [(hi_a, lo_a, val_a), (hi_b, lo_b, val_b)], False, sr_name)


def merge_multi_cuda(block, runs, *, sr_name: str = "plus.times"):
    """Multi-way merge: ``block`` is an (hi, lo, val) triple of an UNSORTED
    buffer, ``runs`` canonical (hi, lo, val) triples, all of any lengths.
    Returns (hi, lo, val, nnz[1]) at the summed length.  CPU tensors run
    ``merge_multi_plain``; CUDA tensors launch the kernel."""
    if _route(block[0]) == "cpu":
        return merge_multi_plain(block, runs, sr_name=sr_name)
    return _launch("merge_multi_cuda", "hier_merge.merge_multi",
                   [tuple(block)] + [tuple(r) for r in runs], True, sr_name)
