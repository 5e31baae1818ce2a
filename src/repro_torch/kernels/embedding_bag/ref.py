"""Oracle for embedding_bag: gather + weighted reduce.  Runs on any device."""
from __future__ import annotations

import torch


def embedding_bag_ref(table, indices, weights):
    """table [V, D]; indices/weights [n_bags, L] -> [n_bags, D] f32.

    Invalid slots are encoded as (index=anything valid, weight=0).
    """
    rows = table[indices.long()].float()                  # [B, L, D]
    return torch.einsum("bl,bld->bd", weights.float(), rows)
