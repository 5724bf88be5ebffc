from loco_edit_tpu_torch.training.trainer import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
from loco_edit_tpu_torch.training.resample import (
    UniformSampler,
    LossSecondMomentResampler,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "UniformSampler",
    "LossSecondMomentResampler",
]
