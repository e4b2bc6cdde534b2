"""Evaluation of the port: completion CD/F1, per class and overall."""

from .metrics import CompletionMetrics, batch_cd_f1

__all__ = ["CompletionMetrics", "batch_cd_f1"]
