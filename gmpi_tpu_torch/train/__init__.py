"""GAN training (port of ``gmpi_tpu/train``): losses, the train step,
checkpoints (``train.checkpoint``) and the training loop (``train.loop``)."""

from gmpi_tpu_torch.train.losses import d_gan_loss, g_gan_loss, r1_penalty
from gmpi_tpu_torch.train.step import (
    TrainState,
    TrainStep,
    flat_pose_from_c2w,
    init_train_state,
    make_optimizers,
    make_train_step,
    set_learning_rates,
)

__all__ = [
    "TrainState",
    "TrainStep",
    "d_gan_loss",
    "flat_pose_from_c2w",
    "g_gan_loss",
    "init_train_state",
    "make_optimizers",
    "make_train_step",
    "r1_penalty",
    "set_learning_rates",
]
