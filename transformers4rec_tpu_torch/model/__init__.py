from . import ranking_metric
from .base import Head, Model
from .prediction_task import NextItemPredictionTask, TaskOutput

__all__ = ["Head", "Model", "NextItemPredictionTask", "TaskOutput", "ranking_metric"]
