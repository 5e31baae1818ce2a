"""Sorted segment-sum kernel — GNN message passing ``out[dst] += msg[e]`` on
Hopper.

``segment_sum_cuda`` launches the hand-written CUDA C++ kernels of
``csrc/segment_agg.cu`` (``sm_90a``), which replace the Pallas kernel
``repro/kernels/segment_agg/segment_agg.py::segment_sum_pallas``.  Its
operands, staged by ``ops.segment_sum``:

``messages``     [E, D] f32: the rows in edge order when ``order`` is
                 given (sorted edge ``e`` is row ``order[e]``, read in
                 place), else already sorted by segment id (the JAX
                 kernel's staged operands, padding rows included);
``seg_ids``      [E] int32 ascending: the sorted (clipped) ids;
``tile_starts``  [num_tiles + 1] int32: the edges whose ids lie in node
                 tile t are [tile_starts[t], tile_starts[t + 1]); only
                 [tile_starts[0], tile_starts[-1]) are summed, so ids at
                 or past the last boundary (dropped) are never read;
``order``        [E] int32 or None: the stable argsort of the ids;

and it returns [num_tiles * tn, D] f32.  The work is cut into chunks of
``CHUNK`` sorted edges, one warp each: a run of one node inside a chunk is
summed there from 0.0 in edge order; a run that crosses chunk boundaries
leaves one piece per chunk, and a second launch adds the pieces in chunk
order.  Float32 throughout, no atomics, no TF32.

``segment_sum_plain`` is its plain PyTorch version on the same operands, in
the same order of additions, so the two agree bit for bit.  A wrapper runs
the plain version for tensors on the CPU and launches the kernels for
tensors on the card; it never falls back from one to the other.  Each call
that launches adds one to ``registry.LAUNCHES["segment_agg.segment_sum"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, registry

SOURCE = "segment_agg/csrc/segment_agg.cu"
COUNTER = "segment_agg.segment_sum"
CHUNK = 64    # sorted edges per warp: kChunk of csrc/segment_agg.cu


def _runs(brk: torch.Tensor):
    """Starts and lengths of the stretches that begin where ``brk`` is
    set (``brk[0]`` is)."""
    start = torch.nonzero(brk).squeeze(1)
    end = torch.cat([start[1:], start.new_tensor([brk.shape[0]])])
    return start, end - start


def segment_sum_plain(messages, seg_ids, tile_starts, num_tiles: int, *,
                      tn: int = 128, order=None):
    """Plain version of ``segment_sum_cuda`` on the same operands."""
    n_out = int(num_tiles) * tn
    d = messages.shape[1]
    dev = messages.device
    out = torch.zeros((n_out, d), dtype=torch.float32, device=dev)
    lo, hi = int(tile_starts[0]), int(tile_starts[-1])
    if hi <= lo or n_out == 0:
        return out
    pos = torch.arange(lo, hi, device=dev)
    node = seg_ids[lo:hi].long()
    rows = pos if order is None else order[lo:hi].long()
    # pieces: the stretches of one node inside one chunk, each summed from
    # 0.0 in edge order (for k = 0, 1, ...: the k-th row of every piece
    # longer than k)
    brk = torch.ones_like(node, dtype=torch.bool)
    brk[1:] = (node[1:] != node[:-1]) | (pos[1:] % CHUNK == 0)
    start, length = _runs(brk)
    piece = torch.zeros((start.shape[0], d), dtype=torch.float32,
                        device=dev)
    active = torch.arange(start.shape[0], device=dev)
    for k in range(int(length.max())):
        active = active[length[active] > k]
        piece[active] = piece[active] + \
            messages[rows[start[active] + k]].float()
    # each node's pieces added in chunk order
    pnode = node[start]
    first = torch.ones_like(pnode, dtype=torch.bool)
    first[1:] = pnode[1:] != pnode[:-1]
    nstart, count = _runs(first)
    acc = piece[nstart]
    active = torch.arange(nstart.shape[0], device=dev)
    for j in range(1, int(count.max())):
        active = active[count[active] > j]
        acc[active] = acc[active] + piece[nstart[active] + j]
    nodes = pnode[nstart]
    keep = (nodes >= 0) & (nodes < n_out)
    out[nodes[keep]] = acc[keep]
    return out


_BOUND = {}


def _lib():
    if "lib" not in _BOUND:
        lib = build.load(SOURCE)
        lib.sa_segment_sum.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sa_segment_sum.restype = ctypes.c_int
        lib.sa_error_string.argtypes = [ctypes.c_int]
        lib.sa_error_string.restype = ctypes.c_char_p
        lib.sa_launch_config.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.sa_launch_config.restype = ctypes.c_int
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _check(messages, seg_ids, tile_starts, num_tiles, order):
    dev = messages.device
    tensors = (messages, seg_ids, tile_starts) + \
        (() if order is None else (order,))
    ok = (messages.dtype == torch.float32 and messages.dim() == 2
          and seg_ids.dtype == torch.int32 and seg_ids.dim() == 1
          and seg_ids.shape[0] == messages.shape[0]
          and tile_starts.dtype == torch.int32
          and tile_starts.shape == (num_tiles + 1,)
          and (order is None or (order.dtype == torch.int32
                                 and order.shape == seg_ids.shape))
          and all(x.device == dev and x.is_contiguous() for x in tensors))
    if not ok:
        raise ValueError(
            "segment_sum_cuda: needs contiguous float32 messages [E, D], "
            "int32 seg_ids [E], int32 tile_starts [num_tiles + 1] and "
            "optionally int32 order [E] on one device; got "
            f"{messages.dtype}{tuple(messages.shape)}, "
            f"{seg_ids.dtype}{tuple(seg_ids.shape)}, "
            f"{tile_starts.dtype}{tuple(tile_starts.shape)}, order "
            f"{None if order is None else (order.dtype, tuple(order.shape))}")


def vector_path(messages) -> int:
    """1 for the ring kernel (float4 rows by bulk copy): D % 4 == 0 and
    the messages 16-byte aligned; else the scalar kernel."""
    return int(messages.shape[1] % 4 == 0 and messages.data_ptr() % 16 == 0)


def _chunks(seg_ids) -> int:
    return max(1, -(-seg_ids.shape[0] // CHUNK))


def segment_sum_launch_config(messages, seg_ids, tile_starts,
                              num_tiles: int, *, tn: int = 128,
                              order=None) -> list:
    """``segment_sum_cuda``'s launches for these operands, as the C side
    decides them (``sa_launch_config``)."""
    num_tiles = int(num_tiles)
    _check(messages, seg_ids, tile_starts, num_tiles, order)
    lib = _lib()
    rows = (ctypes.c_int * (4 * build.MAX_LAUNCHES))()
    n = lib.sa_launch_config(num_tiles, tn, messages.shape[1],
                             _chunks(seg_ids), vector_path(messages), rows,
                             build.MAX_LAUNCHES)
    return build.launch_rows("sa", n, rows)


def segment_sum_cuda(messages, seg_ids, tile_starts, num_tiles: int, *,
                     tn: int = 128, order=None):
    """Sorted segment sum over node tiles of ``tn``; returns
    [num_tiles * tn, D] f32.  CPU tensors run ``segment_sum_plain``; CUDA
    tensors launch the kernels."""
    dev = messages.device.type
    if dev == "cpu":
        return segment_sum_plain(messages, seg_ids, tile_starts, num_tiles,
                                 tn=tn, order=order)
    if dev != "cuda":
        raise ValueError(f"segment_agg: unsupported device {dev}")
    num_tiles = int(num_tiles)
    _check(messages, seg_ids, tile_starts, num_tiles, order)
    d = messages.shape[1]
    out = torch.empty((num_tiles * tn, d), dtype=torch.float32,
                      device=messages.device)
    if num_tiles == 0 or d == 0:
        return out
    chunks = _chunks(seg_ids)
    partial = torch.empty((chunks, 2, d), dtype=torch.float32,
                          device=messages.device)
    vec = vector_path(messages)
    lib = _lib()
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        err = lib.sa_segment_sum(
            messages.data_ptr(), 0 if order is None else order.data_ptr(),
            seg_ids.data_ptr(), tile_starts.data_ptr(), out.data_ptr(),
            partial.data_ptr(), num_tiles, tn, d, chunks, vec, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_cuda: CUDA launch failed with error "
                           f"{err} ({lib.sa_error_string(err).decode()})")
    # each message row and id read once (and its order), each output row
    # written once
    e = seg_ids.shape[0]
    registry.count(COUNTER, e * (4 * d + 4) + (0 if order is None else 4 * e)
                   + 4 * num_tiles * tn * d)
    return out
