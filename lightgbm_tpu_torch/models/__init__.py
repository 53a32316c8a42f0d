from .gbdt import GBDT
from .tree import Tree

__all__ = ["GBDT", "Tree"]
