"""Share of the traced training step in which no kernel, copy or set ran on
the card (one minus the union of device intervals over the step)."""

NAME, UNIT, LAYER, SOURCE, MOVES = ("idle_share.train", "%", "device", "device_trace",
                                    "train_tokens_per_s")


def read(obs):
    if obs.get("kind") != "train" or not obs.get("trace"):
        return None
    t = obs["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
