"""The port's benchmark: seeded D4M traffic driven through ``repro_torch`` on one
card, judged against a plain reference (``python3 port_bench/run.py``)."""
