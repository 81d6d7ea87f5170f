from .store import KGStore, Space

__all__ = ["KGStore", "Space"]
