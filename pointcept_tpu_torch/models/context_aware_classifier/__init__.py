from .context_aware_classifier import CACSegmentor

__all__ = ["CACSegmentor"]
