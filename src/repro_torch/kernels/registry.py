"""Kernel registry — the one job list and the launch counters of the port.

Each ``KernelJob`` names a kernel wrapper with a representative shape /
dtype configuration, a deterministic numpy input maker, the wrapper's plain
PyTorch version and its oracle (``ref.py``).  The input makers
are numpy copies of ``repro/kernels/registry.py``'s, so a job's operands
are bit for bit the reference job's: the CPU tests hold the plain versions
against the JAX kernels on them, and ``chip_smoke.py`` holds the CUDA
kernels against the plain versions on the card.  The ``n65536`` row, the
kernel ceiling, runs on the card here.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the CUDA
kernel (never the plain version): ``hier_merge.merge_multi``,
``hier_merge.merge``, ``embedding_bag.embedding_bag`` and
``segment_agg.segment_sum``; plus ``assoc.sort_route``: every
canonicalization that went through ``torch.sort`` instead — above the
kernel ceiling, or with the kernels off.  A run resets the counters, drives
its path, and reads them to show which route each merge took.  A
wrapper launched inside a captured CUDA graph counts at every replay
(``add_launches``), not at the capture.

``AUDITED_FILES`` names the CUDA sources (relative to this package) that
define kernels; ``build.py`` compiles exactly these.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

AUDITED_FILES = (
    "hier_merge/csrc/hier_merge.cu",
    "embedding_bag/csrc/embedding_bag.cu",
    "segment_agg/csrc/segment_agg.cu",
)

LAUNCHES = {
    "hier_merge.merge_multi": 0,
    "hier_merge.merge": 0,
    "assoc.sort_route": 0,
    "embedding_bag.embedding_bag": 0,
    "segment_agg.segment_sum": 0,
}


def count(name: str) -> None:
    """Add one launch of ``name`` (called by the wrapper that launched)."""
    LAUNCHES[name] += 1


def add_launches(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` to the counters: a captured CUDA graph
    (``stages``) adds the launches recorded at its capture at every
    replay, and takes back the ones counted at the capture itself, where
    nothing ran."""
    for k, n in counts.items():
        LAUNCHES[k] += sign * n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict:
    """A snapshot of the counters."""
    return dict(LAUNCHES)


def refuse_autograd(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` requires grad.  The kernels have no backward, as the JAX
    package's ``pallas_call``s have no differentiation rule: a kernel route
    refuses autograd on every device, so the CPU's plain version cannot
    differentiate where the card cannot, and the card cannot drop a
    gradient by filling a tensor outside the graph."""
    import torch
    if torch.is_grad_enabled() and any(getattr(t, "requires_grad", False)
                                       for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel route has no backward (as in the JAX "
            f"package); differentiate with use_kernel=False")


@dataclasses.dataclass(frozen=True)
class KernelJob:
    """One kernel configuration.

    ``fn`` is the wrapper (plain version on a CPU tensor, CUDA kernel on a
    card tensor); ``plain`` its plain PyTorch version; ``make_inputs`` builds
    numpy operands for a seed; ``oracle`` the reference (``ref.py``) on the
    same operands; ``counter`` the ``LAUNCHES`` key the wrapper bumps."""
    name: str
    family: str
    fn: Callable
    plain: Callable
    make_inputs: Callable[[int], tuple]
    oracle: Callable
    counter: str
    rtol: float = 1e-4


SENTINEL = np.int32(np.iinfo(np.int32).max)

_NP_COMBINE = {"plus.times": np.add, "max.plus": np.maximum,
               "min.plus": np.minimum}


def _np_zero(sr_name: str, dtype) -> np.ndarray:
    if sr_name == "plus.times":
        return np.zeros((), dtype)
    inf = (np.iinfo(dtype).max if np.issubdtype(dtype, np.integer)
           else np.asarray(np.inf, dtype))
    ninf = (np.iinfo(dtype).min if np.issubdtype(dtype, np.integer)
            else np.asarray(-np.inf, dtype))
    return np.asarray(ninf if sr_name.startswith("max") else inf, dtype)


def _canonical_segment(rng, cap: int, nkeys: int, dtype,
                       sr_name: str) -> tuple:
    """A random canonical segment: sorted unique (hi, lo) keys combined
    under the semiring, sentinel-padded to ``cap``."""
    n = cap // 2
    hi = rng.integers(0, nkeys, n).astype(np.int64)
    lo = rng.integers(0, nkeys, n).astype(np.int64)
    val = (rng.integers(-100, 100, n).astype(dtype)
           if np.issubdtype(np.dtype(dtype), np.integer)
           else rng.normal(size=n).astype(dtype))
    key = hi * nkeys + lo
    uniq, inv = np.unique(key, return_inverse=True)
    zero = _np_zero(sr_name, np.dtype(dtype))
    acc = np.full(uniq.shape[0], zero, dtype)
    _NP_COMBINE[sr_name].at(acc, inv, val)
    out_hi = np.full((cap,), SENTINEL, np.int32)
    out_lo = np.full((cap,), SENTINEL, np.int32)
    out_val = np.full((cap,), zero, dtype)
    m = uniq.shape[0]
    out_hi[:m] = (uniq // nkeys).astype(np.int32)
    out_lo[:m] = (uniq % nkeys).astype(np.int32)
    out_val[:m] = acc
    return out_hi, out_lo, out_val


def _merge_inputs(cap_a: int, cap_b: int, nkeys: int, dtype, sr_name: str):
    def make(seed: int) -> tuple:
        rng = np.random.default_rng(seed)
        a = _canonical_segment(rng, cap_a, nkeys, dtype, sr_name)
        b = _canonical_segment(rng, cap_b, nkeys, dtype, sr_name)
        return a + b
    return make


def _merge_multi_inputs(block: int, run_caps: Tuple[int, ...], nkeys: int,
                        dtype, sr_name: str):
    """Operands pre-padded the way the JAX package's ops.merge_multi pads
    them (block to a power of two, then each run so every cumulative size
    stays one), so they are the reference job's bit for bit; the CUDA
    kernel takes them as any other lengths."""
    def next_pow2(n):
        return 1 << (n - 1).bit_length()

    def make(seed: int) -> tuple:
        rng = np.random.default_rng(seed)
        zero = _np_zero(sr_name, np.dtype(dtype))
        cum = next_pow2(max(block, 1))
        bh = np.full((cum,), SENTINEL, np.int32)
        bl = np.full((cum,), SENTINEL, np.int32)
        bv = np.full((cum,), zero, dtype)
        bh[:block] = rng.integers(0, nkeys, block)
        bl[:block] = rng.integers(0, nkeys, block)
        bv[:block] = rng.normal(size=block).astype(dtype)
        runs = []
        for cap in run_caps:
            nxt = next_pow2(cum + cap)
            seg = _canonical_segment(rng, nxt - cum, nkeys, dtype, sr_name)
            runs.append(seg)
            cum = nxt
        return (bh, bl, bv, runs)
    return make


def _embedding_inputs(vocab: int, d: int, bags: int, bag: int):
    def make(seed: int) -> tuple:
        rng = np.random.default_rng(seed)
        table = rng.normal(size=(vocab, d)).astype(np.float32)
        idx = rng.integers(0, vocab, (bags, bag)).astype(np.int32)
        w = rng.normal(size=(bags, bag)).astype(np.float32)
        return table, idx, w
    return make


def _segment_inputs(e: int, d: int, num_tiles: int, tn: int, kb: int):
    """Pre-sorted, block-padded operands exactly as the JAX package's
    ops.segment_sum stages them (sort by segment, pad a full spare block,
    searchsorted starts): the wrapper's form without ``order``."""
    def make(seed: int) -> tuple:
        import torch

        from repro_torch.kernels.segment_agg import ref
        rng = np.random.default_rng(seed)
        num_segments = num_tiles * tn
        seg = np.sort(rng.integers(0, num_segments, e)).astype(np.int32)
        msg = rng.normal(size=(e, d)).astype(np.float32)
        staged = ref.staged_operands(torch.from_numpy(msg),
                                     torch.from_numpy(seg), num_segments,
                                     tn=tn, kb=kb)
        return tuple(x.numpy() for x in staged[:3])
    return make


def jobs() -> Tuple[KernelJob, ...]:
    """The registry: every kernel at the reference's shapes.
    Imports are local so importing this module never loads torch kernels."""
    import functools

    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.hier_merge import hier_merge as hm
    from repro_torch.kernels.hier_merge import ref as hm_ref
    from repro_torch.kernels.segment_agg import ref as sa_ref
    from repro_torch.kernels.segment_agg import segment_agg as sa

    out = []

    def merge_job(cap_a, cap_b, sr_name, dtype, rtol=1e-4):
        name = (f"hier_merge.merge_cuda/n{cap_a + cap_b}"
                f".{sr_name}.{np.dtype(dtype).name}")
        out.append(KernelJob(
            name=name, family="hier_merge",
            fn=functools.partial(hm.merge_cuda, sr_name=sr_name),
            plain=functools.partial(hm.merge_plain, sr_name=sr_name),
            make_inputs=_merge_inputs(cap_a, cap_b, 200, dtype, sr_name),
            oracle=functools.partial(hm_ref.merge_ref, sr_name=sr_name),
            counter="hier_merge.merge", rtol=rtol))

    merge_job(256, 256, "plus.times", np.float32)
    merge_job(256, 256, "max.plus", np.float32)
    merge_job(512, 512, "plus.times", np.int32)
    # the kernel ceiling (ops.MAX_KERNEL_CAPACITY)
    merge_job(1 << 15, 1 << 15, "plus.times", np.float32)

    def multi_fn(bh, bl, bv, runs):
        return hm.merge_multi_cuda((bh, bl, bv), runs, sr_name="plus.times")

    def multi_plain(bh, bl, bv, runs):
        return hm.merge_multi_plain((bh, bl, bv), runs,
                                    sr_name="plus.times")

    def multi_oracle(bh, bl, bv, runs):
        return hm_ref.merge_multi_ref(
            [bh] + [r[0] for r in runs], [bl] + [r[1] for r in runs],
            [bv] + [r[2] for r in runs], sr_name="plus.times")

    out.append(KernelJob(
        name="hier_merge.merge_multi_cuda/n1024.k2",
        family="hier_merge", fn=multi_fn, plain=multi_plain,
        make_inputs=_merge_multi_inputs(192, (256, 512), 300, np.float32,
                                        "plus.times"),
        oracle=multi_oracle, counter="hier_merge.merge_multi", rtol=1e-4))

    out.append(KernelJob(
        name="embedding_bag.embedding_bag_cuda/v512.d128",
        family="embedding_bag", fn=eb.embedding_bag_cuda,
        plain=eb.embedding_bag_plain,
        make_inputs=_embedding_inputs(512, 128, 16, 8),
        oracle=eb_ref.embedding_bag_ref, counter=eb.COUNTER, rtol=2e-5))

    def segment_fn(msg, seg, starts):
        return sa.segment_sum_cuda(msg, seg, starts, 2, tn=128)

    def segment_plain(msg, seg, starts):
        return sa.segment_sum_plain(msg, seg, starts, 2, tn=128)

    def segment_oracle(msg, seg, starts):
        return sa_ref.segment_sum_ref(msg, seg, 256)

    out.append(KernelJob(
        name="segment_agg.segment_sum_cuda/t2.d128",
        family="segment_agg", fn=segment_fn, plain=segment_plain,
        make_inputs=_segment_inputs(384, 128, 2, 128, 128),
        oracle=segment_oracle, counter=sa.COUNTER, rtol=2e-5))
    return tuple(out)
