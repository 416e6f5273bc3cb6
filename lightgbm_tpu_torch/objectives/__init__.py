"""Objective functions of the port: every objective of the JAX
package."""
from .objective import OBJECTIVE_NAMES, Objective, create_objective

__all__ = ["Objective", "create_objective", "OBJECTIVE_NAMES"]
