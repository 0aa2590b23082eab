"""Training: AdamW with float32 master weights, the int8 error-feedback
gradient transform, and the train step, after ``repro/train``."""
