from .node import Node

__all__ = ["Node"]
