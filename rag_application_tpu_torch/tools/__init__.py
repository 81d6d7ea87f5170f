from .registry import Tool, ToolRegistry, tool

__all__ = ["Tool", "ToolRegistry", "tool"]
