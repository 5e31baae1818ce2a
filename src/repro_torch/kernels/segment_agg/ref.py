"""Oracle for segment_agg: ``index_add_`` into zeros, and the JAX package's
staging of the Pallas kernel's operands.  Runs on any device."""
from __future__ import annotations

import torch


def segment_sum_ref(messages, seg_ids, num_segments: int):
    """messages [E, D]; seg_ids [E] -> [num_segments, D] f32.  Ids outside
    [0, num_segments) are dropped, as ``jax.ops.segment_sum`` drops them:
    they land in one spare row that is cut off."""
    n = int(num_segments)
    valid = (seg_ids >= 0) & (seg_ids < n)
    ids = torch.where(valid, seg_ids, n).long()
    out = torch.zeros((n + 1, messages.shape[1]), dtype=torch.float32,
                      device=messages.device)
    return out.index_add_(0, ids, messages.float())[:n]


def staged_operands(messages, seg_ids, num_segments: int, *, tn: int = 128,
                    kb: int = 128):
    """The Pallas kernel's operands as ``repro/kernels/segment_agg/ops.py``
    stages them: ids outside [0, num_segments) clipped to
    ``num_segments``; ids and f32 messages stably sorted by id; both padded
    to ceil(E/kb)*kb + kb rows (ids ``T * tn``, zero rows); the
    ``searchsorted`` starts of the ``tn``-node tiles.  Returns (msg_pad,
    seg_pad, tile_starts, T): ``segment_sum_cuda``'s operands without
    ``order``."""
    e, d = messages.shape
    n, dev = int(num_segments), messages.device
    seg = seg_ids.to(torch.int32)
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    seg_sorted, order = torch.sort(seg, stable=True)
    num_tiles = -(-n // tn)
    pad = -(-e // kb) * kb + kb - e
    msg_pad = torch.cat([messages.float()[order],
                         torch.zeros((pad, d), device=dev)])
    seg_pad = torch.cat([seg_sorted, torch.full((pad,), num_tiles * tn,
                                                dtype=torch.int32,
                                                device=dev)])
    starts = torch.searchsorted(
        seg_pad, torch.arange(0, (num_tiles + 1) * tn, tn, dtype=torch.int32,
                              device=dev), out_int32=True)
    return msg_pad, seg_pad, starts, num_tiles
