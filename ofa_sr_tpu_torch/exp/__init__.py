"""End-to-end experiment scripts of the port (counterpart of the JAX
repository's exp/ scripts), each run as `python -m ofa_sr_tpu_torch.exp.<name>`:

- `curriculum`: the SR curriculum (teacher -> pretrain -> kernel -> depth ->
  expand -> pixelshuffle_depth) through the port's CLIs on a generated PNG
  tree, with per-phase grid PSNR-Y and a bicubic floor;
- `merge_curriculum_reports`: the headline (trained margins over bicubic)
  and the join of a JAX half-report with a port half-report;
- `search_deploy_demo`: the expand checkpoint through a decoder latency
  table, the evolutionary finder and recalibrated deployment.

They run on the card unless given `--device cpu`.
"""
