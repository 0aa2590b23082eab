"""Command-line entry points, after ``repro/launch``: ``serve_lp``."""
