"""kernels_per_request: device activities (kernels, copies, fills) in
the traced window over the requests.

Keyed on the kind's name, ``infer``, and not on what the window
counts: a request here is one whole-graph forward, which a request of
another kind need not be.  A new kind brings per-layer readers of its
own."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "infer" or not tr:
        return None
    return tr["device_ops"] / rec["count"]
