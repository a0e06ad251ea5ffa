"""95th percentile of the time from submit to first token, over every
request whose first token reached the host in the serving window
(``Completion.first_token_time``): the end-to-end ``ttft_p95_ms``, read
per layer in cells whose host-paced step leaves it too unsteady for a
bound."""

from benchmark.harness import percentile

NAME, UNIT, LAYER, SOURCE, MOVES = ("ttft_p95_ms.serve", "ms", "inference/engine.py",
                                    "host_clock", "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("ttft_s"):
        return None
    return 1e3 * percentile(obs["ttft_s"], 95)
