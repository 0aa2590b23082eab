"""The synthetic LM data stream, after ``repro/data``."""
