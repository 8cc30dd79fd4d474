"""Command-line entry points of the port (`python -m
ofa_sr_tpu_torch.cli.<name>`): the S4 teacher trainer and the SR
evaluator. They run on the card unless `--device cpu` is given."""
