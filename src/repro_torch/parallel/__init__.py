"""Input layouts for the port's parallel executors."""
from .sharding import weighted_spatial_inputs

__all__ = ["weighted_spatial_inputs"]
