from .convert import from_reference

__all__ = ["from_reference"]
