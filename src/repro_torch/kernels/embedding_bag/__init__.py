"""Embedding-bag gather-reduce (the DCN-v2 serving lookup)."""
