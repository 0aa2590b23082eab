"""The benchmark's CPU tests: the harness's modules on ``sys.path``, the ``gpu`` marker."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; the test decides inside itself and skips without one",
    )
