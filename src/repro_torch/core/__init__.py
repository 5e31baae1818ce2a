"""Core: hierarchical in-memory associative arrays (the paper's contribution)."""
from repro_torch.core import assoc, distributed, hier, semiring, stream  # noqa: F401
from repro_torch.core.assoc import SENTINEL, AssocSegment  # noqa: F401
from repro_torch.core.hier import HierAssoc  # noqa: F401
from repro_torch.core.semiring import MAX_MIN, MAX_PLUS, MIN_PLUS, PLUS_TIMES  # noqa: F401
