"""Serving runtime of the port."""
from .serve import BatchingEngine, Request, ServeConfig

__all__ = ["BatchingEngine", "Request", "ServeConfig"]
