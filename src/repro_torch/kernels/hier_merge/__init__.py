"""Canonical-segment merge kernels (two-way and multi-way)."""
