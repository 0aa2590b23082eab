"""Robustness: seeded fault injection (``chaos.py``) and straggler
mitigation (``straggler.py``), after ``repro/runtime``."""
