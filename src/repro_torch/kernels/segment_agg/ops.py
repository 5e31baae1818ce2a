"""Public wrapper for segment_agg.

Takes an unsorted (seg_id, message) edge set, sorts it by segment (a
stable sort, as JAX's ``argsort`` is), pads to block granularity, computes
the per-node-tile edge offsets with ``searchsorted`` and dispatches to the
kernel wrapper — or, with ``use_kernel=False``, to the oracle — as
``repro/kernels/segment_agg/ops.py`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_agg import ref
from repro_torch.kernels.segment_agg.segment_agg import segment_sum_cuda

TN = 128   # nodes per tile (one CTA each)
KB = 128   # edge padding granularity of the reference's staging


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def stage(messages, seg_ids, *, num_segments: int,
          assume_sorted: bool = False):
    """The kernel's operands: (messages [E_pad, D], seg_ids [E_pad] int32
    ascending, tile_starts [T + 1] int32, T).  Ids outside
    [0, num_segments) become ``num_segments`` (a row the caller cuts off);
    E_pad = ceil(E / KB) * KB + KB, the padding rows carrying id T * TN."""
    e, d = messages.shape
    dev = messages.device
    seg_ids = seg_ids.to(torch.int32)
    seg_clip = torch.where((seg_ids >= 0) & (seg_ids < num_segments),
                           seg_ids, num_segments)
    if assume_sorted:
        seg_sorted, msg_sorted = seg_clip, messages
    else:
        order = torch.argsort(seg_clip, stable=True)
        seg_sorted, msg_sorted = seg_clip[order], messages[order]

    num_tiles = _ceil_to(num_segments, TN) // TN
    pad = _ceil_to(e, KB) + KB - e
    seg_pad = torch.cat([seg_sorted, torch.full((pad,), num_tiles * TN,
                                                dtype=torch.int32,
                                                device=dev)])
    msg_pad = torch.cat([msg_sorted.float(),
                         torch.zeros((pad, d), dtype=torch.float32,
                                     device=dev)])
    boundaries = torch.arange(num_tiles + 1, dtype=torch.int32,
                              device=dev) * TN
    tile_starts = torch.searchsorted(seg_pad, boundaries,
                                     side="left").to(torch.int32)
    return msg_pad, seg_pad, tile_starts, num_tiles


def segment_sum(messages, seg_ids, *, num_segments: int,
                use_kernel: bool = True, assume_sorted: bool = False):
    """Segment-sum messages [E, D] by seg_ids [E] -> [num_segments, D] f32.

    seg_ids outside [0, num_segments) are treated as padding and dropped.
    """
    if not use_kernel:
        return ref.segment_sum_ref(messages, seg_ids, num_segments)
    msg_pad, seg_pad, tile_starts, num_tiles = stage(
        messages, seg_ids, num_segments=num_segments,
        assume_sorted=assume_sorted)
    out = segment_sum_cuda(msg_pad, seg_pad, tile_starts, num_tiles, tn=TN)
    return out[:num_segments]
