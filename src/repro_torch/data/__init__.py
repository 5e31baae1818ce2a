"""Data substrate: the R-MAT power-law update streams."""
