from .trainer import SageTrainer, TrainConfig
