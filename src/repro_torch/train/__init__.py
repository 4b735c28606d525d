from .step import TrainConfig, abstract_state, init_state, make_train_step

__all__ = ["TrainConfig", "make_train_step", "init_state", "abstract_state"]
