"""Milliseconds a lockstep decode step takes in the serving window: the
window's seconds over its dispatches times K (``InferenceEngine.stats()``'s
dispatch counter)."""

NAME, UNIT, LAYER, SOURCE, MOVES = ("step_ms.serve", "ms", "inference/engine.py",
                                    "program_counter", "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs["dispatches"]:
        return None
    return 1e3 * obs["window_s"] / (obs["dispatches"] * obs["steps_per_dispatch"])
