"""Offline tools (counterpart of ofa_sr_tpu/tools/): media preprocessing."""
