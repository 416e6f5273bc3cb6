"""Objective functions of the port: binary logloss and L2 regression."""
from .objective import OBJECTIVE_NAMES, Objective, create_objective

__all__ = ["Objective", "create_objective", "OBJECTIVE_NAMES"]
