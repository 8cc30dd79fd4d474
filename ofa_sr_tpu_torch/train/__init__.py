from .bn_recalib import bn_recalibrate
from .checkpoint import (
    load_checkpoint,
    load_weights_lenient,
    s4_state_dict_from_jax,
    save_checkpoint,
    save_weights,
)
from .optim import build_optimizer, param_groups
from .run_manager import RunConfig, SRRunManager
from .schedules import lr_at_step
from .train_step import SRTrainer

__all__ = ["RunConfig", "SRRunManager", "SRTrainer", "bn_recalibrate", "build_optimizer",
           "load_checkpoint", "load_weights_lenient", "lr_at_step", "param_groups",
           "s4_state_dict_from_jax", "save_checkpoint", "save_weights"]
