"""Hand-written CUDA kernels for Hopper and their wrappers.

``csrc/simplex.cu`` replaces ``repro/kernels/simplex_pallas.py`` and
``csrc/hyperbox.cu`` replaces ``repro/kernels/hyperbox_pallas.py``.
Nothing is compiled at import: ``build.py`` runs ``nvcc`` at the first
launch on a CUDA tensor.
"""
