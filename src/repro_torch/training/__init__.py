"""Training substrate: optimizer, train step, checkpointing, compression,
fault tolerance (the reference's ``repro.training``)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr  # noqa: F401
from .train_step import TrainConfig, make_train_step  # noqa: F401
