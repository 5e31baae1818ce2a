"""Read side of the hierarchy: batched point lookups against live state."""
