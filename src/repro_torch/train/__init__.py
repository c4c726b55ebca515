"""Training: AdamW, the loss and train step, ``.npz`` checkpoints."""
from repro_torch.train.optimizer import adamw_init, adamw_update, cosine_lr  # noqa: F401
from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
