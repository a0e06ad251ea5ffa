"""The whole training step's share of the card's bf16 peak over the window:
model FLOPs of every step that finished in it (6 per weight per real token
over the layer projections and the head, and 3x the causal attention
forward over real tokens; ``roofline.train_flops``) over the window's
seconds and 989 TFLOP/s."""

from benchmark import roofline

NAME, UNIT, LAYER, SOURCE, MOVES = ("mfu.train", "%", "training/train_step.py", "host_clock",
                                    "train_tokens_per_s")


def read(obs):
    if obs.get("kind") != "train" or not obs["lengths"]:
        return None
    flops = roofline.train_flops(obs["cfg"], obs["lengths"])
    return 100.0 * flops / obs["window_s"] / roofline.PEAK_FLOPS
