from .full_graph import (FullGraphConfig, FullGraphModel, FullGraphTrainer,
                         log_eps_cross_entropy)
from .trainer import SageTrainer, TrainConfig
