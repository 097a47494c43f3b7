"""Synthetic workloads (copy of ``src/repro/data/synthetic.py``)."""
