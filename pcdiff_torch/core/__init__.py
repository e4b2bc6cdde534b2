"""Parameters and devices of the port: seeded initialisation, weights to and from the
JAX package's parameter trees, and the device the entry points run on."""

from .device import resolve_device
from .weights import flax_from_params, init_params, params_from_flax

__all__ = ["init_params", "params_from_flax", "flax_from_params", "resolve_device"]
