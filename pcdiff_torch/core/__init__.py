"""Parameters of the port: seeded initialisation and weights from the JAX package."""

from .weights import init_params, params_from_flax

__all__ = ["init_params", "params_from_flax"]
