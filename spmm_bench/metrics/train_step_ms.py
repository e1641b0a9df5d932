"""train_step_ms: the window's milliseconds over the training steps it
ran (a synchronise only at each end)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["window_s"] / rec["count"] * 1e3
