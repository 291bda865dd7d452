from .loader import (
    find_feature_files,
    load_feature_file,
    TestSplit,
    iterate_training_batches,
)
from .trainer import TrainConfig, train_run, make_train_step
