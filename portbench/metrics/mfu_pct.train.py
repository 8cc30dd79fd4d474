"""The whole training step's share of the card's peak: 6 x the sampled
subnets' forward MACs (2 a MAC forward, 4 backward), plus 2 x the KD
teacher's, over the untraced window's seconds, against the dense peak of
the compute type (bf16 989 TFLOP/s; float32 495, TF32's, since float32
products may run as TF32 splits on the tensor cores). MACs from the frozen
closed forms in portbench/flops.py."""

UNIT, BETTER = "%", "higher"
LAYER = "trainer and model: train/train_step.py, train/cls_trainer.py, models/"
MOVES = "train_imgs_per_s"


def read(ctx):
    w = ctx.window
    if not w.get("seconds") or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / w["peak_flops"]
