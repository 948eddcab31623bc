"""Training: configuration, forward loss, optimizer, loop and checkpoints."""

from .config import (  # noqa: F401
    TrainingConfig,
    apply_overrides,
    load_config,
    make_coarse_cfg,
    make_refiner_cfg,
    save_config,
    update_cfg_debug,
)
from .forward_loss import BatchPoseData, make_hypotheses  # noqa: F401
from .train import (  # noqa: F401
    TrainState,
    create_train_state,
    load_checkpoint,
    save_checkpoint,
    synthetic_batch_fn,
)

# The JAX package's `__init__.py` also binds its functions `train` and
# `forward_loss` here, over its submodules of those names; the port keeps
# `training.train` and `training.forward_loss` the modules (the functions
# are `training.train.train` and `training.forward_loss.forward_loss`), as
# its scripts and tests import them.
