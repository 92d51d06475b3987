"""``forward_ms.<kind>``: the CUDA-event time of the model's forward (pre-
to post-hook on the model instance) summed over the window, per request or
step."""


def read(r):
    if not r.units or "forward" not in r.spans_ms:
        return None
    return r.spans_ms["forward"] / r.units
