"""Sorted segment-sum kernel — GNN message passing ``out[dst] += msg[e]`` on
Hopper.

``segment_sum_cuda`` launches the hand-written CUDA C++ kernel of
``csrc/segment_agg.cu`` (``sm_90a``), which replaces the Pallas kernel
``repro/kernels/segment_agg/segment_agg.py::segment_sum_pallas`` and keeps
its operand contract, staged by ``ops.segment_sum``:

``messages``     [E_pad, D] f32, sorted by segment id;
``seg_ids``      [E_pad] int32 ascending; padding rows carry ids
                 >= num_tiles * tn;
``tile_starts``  [num_tiles + 1] int32: tile t owns the edges
                 [tile_starts[t], tile_starts[t + 1]), whose ids lie in
                 [t * tn, (t + 1) * tn);

and returns [num_tiles * tn, D] f32.  The TPU kernel's one-hot matmul is
not carried over: one CTA per node tile sums each node's contiguous run of
rows in edge order, in float32 with no atomics and no TF32.

``segment_sum_plain`` is its plain PyTorch version on the same operands:
for k = 0, 1, ... it adds the k-th row of every node that has more than k
edges, which is the kernel's order of additions, so the two agree bit for
bit.  A wrapper runs the plain version for tensors on the CPU and launches
the kernel for tensors on the card; it never falls back from one to the
other.  Each launch adds one to
``registry.LAUNCHES["segment_agg.segment_sum"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, registry

SOURCE = "segment_agg/csrc/segment_agg.cu"
COUNTER = "segment_agg.segment_sum"


def segment_sum_plain(messages, seg_ids, tile_starts, num_tiles: int, *,
                      tn: int = 128):
    """Plain version of ``segment_sum_cuda`` on the staged operands."""
    n_out = int(num_tiles) * tn
    e_pad, d = messages.shape
    dev = messages.device
    pos = torch.arange(e_pad, device=dev)
    # the edges the tiles own: [tile_starts[0], tile_starts[-1])
    owned = (pos >= tile_starts[0]) & (pos < tile_starts[-1])
    node = torch.where(owned, seg_ids.long(), n_out)
    deg = torch.bincount(node, minlength=n_out + 1)[:n_out]
    first = torch.searchsorted(seg_ids.long(), torch.arange(n_out, device=dev))
    first = torch.maximum(first, tile_starts[0].long())
    out = torch.zeros((n_out, d), dtype=torch.float32, device=dev)
    active = torch.arange(n_out, device=dev)
    max_deg = int(deg.max()) if n_out else 0
    for k in range(max_deg):
        active = active[deg[active] > k]
        out[active] = out[active] + messages[first[active] + k].float()
    return out


_BOUND = {}


def _lib():
    if "lib" not in _BOUND:
        lib = build.load(SOURCE)
        lib.sa_segment_sum.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.sa_segment_sum.restype = ctypes.c_int
        lib.sa_error_string.argtypes = [ctypes.c_int]
        lib.sa_error_string.restype = ctypes.c_char_p
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check(messages, seg_ids, tile_starts, num_tiles):
    dev = messages.device
    ok = (messages.dtype == torch.float32 and messages.dim() == 2
          and seg_ids.dtype == torch.int32 and seg_ids.dim() == 1
          and seg_ids.shape[0] == messages.shape[0]
          and tile_starts.dtype == torch.int32
          and tile_starts.shape == (num_tiles + 1,)
          and seg_ids.device == dev and tile_starts.device == dev
          and all(x.is_contiguous() for x in (messages, seg_ids,
                                              tile_starts)))
    if not ok:
        raise ValueError(
            "segment_sum_cuda: needs contiguous float32 messages [E, D], "
            "int32 seg_ids [E] and int32 tile_starts [num_tiles + 1] on one "
            f"device; got {messages.dtype}{tuple(messages.shape)}, "
            f"{seg_ids.dtype}{tuple(seg_ids.shape)}, "
            f"{tile_starts.dtype}{tuple(tile_starts.shape)}")


def segment_sum_cuda(messages, seg_ids, tile_starts, num_tiles: int, *,
                     tn: int = 128):
    """Sorted segment sum over node tiles of ``tn``; returns
    [num_tiles * tn, D] f32.  CPU tensors run ``segment_sum_plain``; CUDA
    tensors launch the kernel."""
    dev = messages.device.type
    if dev == "cpu":
        return segment_sum_plain(messages, seg_ids, tile_starts, num_tiles,
                                 tn=tn)
    if dev != "cuda":
        raise ValueError(f"segment_agg: unsupported device {dev}")
    num_tiles = int(num_tiles)
    _check(messages, seg_ids, tile_starts, num_tiles)
    d = messages.shape[1]
    out = torch.empty((num_tiles * tn, d), dtype=torch.float32,
                      device=messages.device)
    if num_tiles == 0 or d == 0:
        return out
    vec = int(d % 4 == 0 and messages.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        err = lib.sa_segment_sum(messages.data_ptr(), seg_ids.data_ptr(),
                                 tile_starts.data_ptr(), out.data_ptr(),
                                 num_tiles, tn, d, vec, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_cuda: CUDA launch failed with error "
                           f"{err} ({lib.sa_error_string(err).decode()})")
    registry.count(COUNTER)
    return out
