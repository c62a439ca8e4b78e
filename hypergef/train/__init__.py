from hypergef.train.splits import rand_train_test_idx, accuracy
from hypergef.train.trainer import TrainConfig, Trainer, train_full_batch

__all__ = [
    "rand_train_test_idx",
    "accuracy",
    "TrainConfig",
    "Trainer",
    "train_full_batch",
]
