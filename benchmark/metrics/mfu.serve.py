"""The whole decode step's share of the card's peak over the serving window:
the least time of every lockstep step queued in the window (the larger of
its FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s: every layer weight
read once, the window head, and each slot's live K/V rows read and new row
written, ``roofline.decode_step``) over the window's seconds. The rows come
from the pool's lengths copied behind each dispatch (traced runs)."""

from benchmark import roofline

NAME, UNIT, LAYER, SOURCE, MOVES = ("mfu.serve", "%", "models/llama.py", "program_counter",
                                    "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("dispatch_rows"):
        return None
    least = 0.0
    for tag, steps in obs["dispatch_rows"]:
        if tag != "window":
            continue
        for rows in steps:
            live = rows[rows > 1]  # idle slots read their one dead row and do no work
            flops, nbytes = roofline.decode_step(obs["cfg"], live, obs["window"][1])
            least += roofline.least_seconds(flops, nbytes)
    return 100.0 * least / obs["window_s"]
