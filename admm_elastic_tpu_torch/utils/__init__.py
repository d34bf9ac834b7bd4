from .convert import banded_from_reference, cloth_from_reference, from_reference

__all__ = ["banded_from_reference", "cloth_from_reference", "from_reference"]
