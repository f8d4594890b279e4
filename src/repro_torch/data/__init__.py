"""Deterministic synthetic data of the port's trainer (twin of ``repro/data``)."""
from .pipeline import DiffusionStream, ImageStream, TokenStream, device_batch

__all__ = ["DiffusionStream", "ImageStream", "TokenStream", "device_batch"]
