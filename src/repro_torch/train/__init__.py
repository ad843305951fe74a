from .step import TrainState, make_train_step  # noqa: F401
