from .checkpoint import s4_state_dict_from_jax
from .optim import build_optimizer, param_groups
from .schedules import lr_at_step
from .train_step import SRTrainer

__all__ = ["SRTrainer", "build_optimizer", "lr_at_step", "param_groups",
           "s4_state_dict_from_jax"]
