"""Sorted segment sum (GNN message passing)."""
