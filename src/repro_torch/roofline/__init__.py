"""Roofline extraction from recorded dry-run calls (the counterpart of
``repro/roofline``)."""
from repro_torch.roofline.hlo import collective_bytes_by_type, parse_hlo_collectives  # noqa: F401
from repro_torch.roofline.terms import HW_H100, roofline_terms  # noqa: F401
