"""Public wrapper for segment_agg.

Takes an unsorted (seg_id, message) edge set, clips the ids to
``[0, num_segments]`` (``num_segments`` marks a dropped edge), sorts them
(a stable sort, as JAX's ``argsort`` is), takes the per-node-tile edge
offsets with ``searchsorted`` and dispatches to the kernel wrapper — or,
with ``use_kernel=False``, to the oracle — as
``repro/kernels/segment_agg/ops.py`` does.  Unlike the reference it makes no
sorted or padded copy of the messages: the kernel reads them in place
through the sort order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.segment_agg import ref
from repro_torch.kernels.segment_agg.segment_agg import segment_sum_cuda

TN = 128   # nodes per tile of the output


def stage(seg_ids, *, num_segments: int, assume_sorted: bool = False):
    """The kernel's id operands: (order [E] int32 or None, seg_sorted [E]
    int32 ascending, tile_starts [T + 1] int32, T).  Ids outside
    [0, num_segments) become ``num_segments`` (sorted last); the last tile
    boundary is ``num_segments``, not ``T * TN``, so those edges lie past
    ``tile_starts[T]`` and are never read.  With ``assume_sorted`` the ids
    are taken in their order and ``order`` is None."""
    seg_ids = seg_ids.to(torch.int32)
    seg_clip = torch.where((seg_ids >= 0) & (seg_ids < num_segments),
                           seg_ids, num_segments)
    if assume_sorted:
        order, seg_sorted = None, seg_clip
    else:
        seg_sorted, order = torch.sort(seg_clip, stable=True)
        order = order.to(torch.int32)
    num_tiles = -(-num_segments // TN)
    boundaries = torch.arange(0, (num_tiles + 1) * TN, TN, dtype=torch.int32,
                              device=seg_ids.device).clamp_(max=num_segments)
    tile_starts = torch.searchsorted(seg_sorted, boundaries, out_int32=True)
    return order, seg_sorted, tile_starts, num_tiles


def segment_sum(messages, seg_ids, *, num_segments: int,
                use_kernel: bool = True, assume_sorted: bool = False):
    """Segment-sum messages [E, D] by seg_ids [E] -> [num_segments, D] f32.

    seg_ids outside [0, num_segments) are treated as padding and dropped.
    With ``use_kernel`` it raises ``NotImplementedError`` when grad mode is
    on and ``messages`` requires grad (the kernel has no backward).
    """
    if not use_kernel:
        return ref.segment_sum_ref(messages, seg_ids, num_segments)
    registry.refuse_autograd("segment_sum", messages)
    order, seg_sorted, tile_starts, num_tiles = stage(
        seg_ids, num_segments=num_segments, assume_sorted=assume_sorted)
    out = segment_sum_cuda(messages.to(torch.float32).contiguous(),
                           seg_sorted, tile_starts, num_tiles, tn=TN,
                           order=order)
    return out[:num_segments]
