from .checkpoint import s4_state_dict_from_jax

__all__ = ["s4_state_dict_from_jax"]
