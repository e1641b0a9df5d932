"""host_enqueue_ms: the mean host time from a request's start to the
forward's return, before its synchronise (the benchmark's span)."""


def read(rec):
    spans = rec["spans"].get("enqueue")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
