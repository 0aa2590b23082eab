"""The LM model scaffolding, following ``repro/models`` (the dense family so far)."""

from .config import ModelConfig
from .model import Model

__all__ = ["ModelConfig", "Model"]
