from .litept import LitePT

__all__ = ["LitePT"]
