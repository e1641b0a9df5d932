"""setup_s: seconds from the process's start to the window's start
(graph, ordering, upload, the autotuner, plan build, inputs, warm-up)."""


def read(rec):
    return rec.get("setup_s")
