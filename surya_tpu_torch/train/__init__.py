"""Training: the train and eval steps (``steps``), the epoch loop with
early stopping, plateau LR, checkpoints and resume (``loop``), and the
multi-checkpoint comparison (``compare``)."""

from surya_tpu_torch.train.loop import (  # noqa: F401
    EarlyStopping,
    Plateau,
    evaluate,
    train_and_evaluate,
)
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
