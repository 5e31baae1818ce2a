"""Launchers: the instance-fleet ingest CLI and its profiler."""
