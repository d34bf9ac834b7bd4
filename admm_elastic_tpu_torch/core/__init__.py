from .system import System, Settings

__all__ = ["System", "Settings"]
