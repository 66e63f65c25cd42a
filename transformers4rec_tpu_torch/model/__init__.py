from . import ranking_metric
from .base import Head, Model
from .losses import binary_cross_entropy_with_logits, cross_entropy_with_logits, mse_loss
from .prediction_task import (
    BinaryClassificationTask,
    LogUniformSampler,
    NextItemPredictionTask,
    PredictionTask,
    RegressionTask,
    TaskOutput,
)

__all__ = ["BinaryClassificationTask", "Head", "LogUniformSampler", "Model",
           "NextItemPredictionTask", "PredictionTask", "RegressionTask", "TaskOutput",
           "binary_cross_entropy_with_logits", "cross_entropy_with_logits", "mse_loss",
           "ranking_metric"]
