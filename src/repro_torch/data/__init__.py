"""Data substrate: R-MAT power-law update streams, synthetic recsys and
token batches, the GNN graph builders and the prefetching batch stream."""
