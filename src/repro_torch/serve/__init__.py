"""The LP serve loop (``engine.py:LPEngine``) and its open-loop load
generator (``loadgen.py``), after ``repro/serve``."""
