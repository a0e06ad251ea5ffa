"""95th percentile, over the requests completed in the serving window, of
(finish - first token) / seconds of audio produced: the end-to-end
``stream_rtf_p95``, read per layer in cells whose host-paced step leaves
it too unsteady for a bound."""

from benchmark.harness import percentile

NAME, UNIT, LAYER, SOURCE, MOVES = ("stream_rtf_p95.serve", "ratio", "inference/engine.py",
                                    "host_clock", "audio_s_per_s")


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("stream_rtf"):
        return None
    return percentile(obs["stream_rtf"], 95)
