"""``pyramid_ms.<kind>``: the CUDA-event time of ``Predictor.prepare`` (the
copy in, the Morton sort and the windowed pyramid) summed over the window,
per request."""


def read(r):
    if not r.units or "prepare" not in r.spans_ms:
        return None
    return r.spans_ms["prepare"] / r.units
