"""Data substrate: R-MAT power-law update streams, synthetic recsys batches
and the GNN graph builders."""
