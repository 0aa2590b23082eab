"""Command-line entry points, after ``repro/launch``: ``serve_lp``, ``train``
(and ``op_stats``, the operation counter)."""
