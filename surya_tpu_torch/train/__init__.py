"""Training: the train and eval steps (``steps``). The loop,
checkpoints and CLI come with later slices."""

from surya_tpu_torch.train.steps import (  # noqa: F401
    TrainState,
    create_train_state,
    get_learning_rate,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
    trainable_mask,
)
