"""train_step_ms: the window's milliseconds over the training steps it
ran (a synchronise only at each end).  Read in any cell whose window
counts training steps (``counts`` is ``train_steps``), of whatever
traffic kind."""


def read(rec):
    if rec.get("counts") != "train_steps":
        return None
    return rec["window_s"] / rec["count"] * 1e3
