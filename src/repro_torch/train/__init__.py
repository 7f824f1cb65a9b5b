from .loop import TrainLoop
from .steps import compute_loss, make_qlora_step, make_train_step

__all__ = ["compute_loss", "make_train_step", "make_qlora_step", "TrainLoop"]
