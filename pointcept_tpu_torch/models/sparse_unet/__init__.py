from .spconv_unet import SpUNetBase

__all__ = ["SpUNetBase"]
