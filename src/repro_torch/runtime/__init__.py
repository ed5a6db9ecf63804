"""Runtime: trainer loop, fault tolerance, elastic re-meshing."""

from .fault_tolerance import (FailureSimulator, Heartbeat, StragglerDetector,
                              retry_with_backoff)
from .trainer import Trainer, TrainerConfig, train_loop
from .elastic import ElasticPlan, plan_elastic_mesh, rescale_batch

__all__ = ["FailureSimulator", "Heartbeat", "StragglerDetector",
           "retry_with_backoff", "Trainer", "TrainerConfig", "train_loop",
           "ElasticPlan", "plan_elastic_mesh", "rescale_batch"]
