"""``launches.<kind>``: device kernels (copies and fills not counted) in
the profiled slice, per request or step."""


def read(r):
    if not r.slice:
        return None
    return r.slice["launches"] / r.slice["units"]
