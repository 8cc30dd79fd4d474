from .bn_recalib import bn_recalibrate
from .checkpoint import (
    load_checkpoint,
    load_weights_lenient,
    s4_state_dict_from_jax,
    save_checkpoint,
    save_weights,
    x4_state_dict_from_jax,
)
from .cls_run_manager import ClsRunManager
from .cls_trainer import ClsTrainer, cross_entropy, soft_target_ce, topk_accuracy
from .optim import build_optimizer, param_groups
from .run_manager import RunConfig, SRRunManager
from .schedules import lr_at_step
from .shrink import supporting_elastic, validate_grid
from .train_step import SRTrainer

__all__ = ["ClsRunManager", "ClsTrainer", "cross_entropy", "soft_target_ce", "topk_accuracy",
           "RunConfig", "SRRunManager", "SRTrainer", "bn_recalibrate", "build_optimizer",
           "load_checkpoint", "load_weights_lenient", "lr_at_step", "param_groups",
           "s4_state_dict_from_jax", "save_checkpoint", "save_weights",
           "supporting_elastic", "validate_grid", "x4_state_dict_from_jax"]
