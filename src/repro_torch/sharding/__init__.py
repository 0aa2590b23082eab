from .rules import ParamSpec, leaves, materialize

__all__ = ["ParamSpec", "leaves", "materialize"]
