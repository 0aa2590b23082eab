"""Robustness: seeded fault injection (``chaos.py``), straggler
mitigation (``straggler.py``) and the restartable training driver
(``fault.py``), after ``repro/runtime``; the autotuner and the roofline
model (``autotune.py``, ``roofline.py``)."""
