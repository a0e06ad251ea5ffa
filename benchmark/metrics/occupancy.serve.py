"""Share of the pool's slots holding a request, averaged over the polls of
the serving window (``InferenceEngine.stats()["active_slots"]`` over
``max_batch``)."""

NAME, UNIT, LAYER, SOURCE, MOVES = ("occupancy.serve", "%", "inference/engine.py",
                                    "program_counter", "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs["occupancy"]:
        return None
    return 100.0 * sum(obs["occupancy"]) / len(obs["occupancy"]) / obs["max_batch"]
