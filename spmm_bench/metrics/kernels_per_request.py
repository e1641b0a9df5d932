"""kernels_per_request: device activities (kernels, copies, fills) in
the traced window over the requests."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "infer" or not tr:
        return None
    return tr["device_ops"] / rec["count"]
