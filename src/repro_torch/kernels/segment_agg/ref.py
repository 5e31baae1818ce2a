"""Oracle for segment_agg: ``index_add_`` into zeros.  Runs on any device."""
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
