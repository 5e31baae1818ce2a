"""Models of the port: DCN-v2 serving and the GNN forward pass."""
