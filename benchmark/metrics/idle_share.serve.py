"""Share of the traced slice of the serving window in which no kernel, copy
or set ran on the card (one minus the union of device intervals over the
slice)."""

NAME, UNIT, LAYER, SOURCE, MOVES = ("idle_share.serve", "%", "device", "device_trace",
                                    "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("trace"):
        return None
    t = obs["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
