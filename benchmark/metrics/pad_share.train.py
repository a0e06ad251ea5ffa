"""Share of the window's batch positions that are padding: the positions
``collate`` added to reach each batch's bucket, over all positions of the
batches of the window's steps."""

NAME, UNIT, LAYER, SOURCE, MOVES = ("pad_share.train", "%", "data/collate.py",
                                    "program_counter", "train_tokens_per_s")


def read(obs):
    if obs.get("kind") != "train" or not obs["padded"]:
        return None
    return 100.0 * (obs["padded"] - obs["tokens"]) / obs["padded"]
