"""Evaluation metrics of the port (reference factory: src/metric/metric.cpp)."""
from .metric import METRIC_NAMES, Metric, create_metric, create_metrics

__all__ = ["Metric", "create_metric", "create_metrics", "METRIC_NAMES"]
