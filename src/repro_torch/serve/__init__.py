"""The LM decode loop (``engine.py:Engine``), the LP serve loop
(``engine.py:LPEngine``) and its open-loop load generator
(``loadgen.py``), after ``repro/serve``."""
