"""``crf_ms.<kind>``: the CUDA-event time of the program's ``crf`` spans
(``GuideCRFConv``'s similarity and mean field) a request, in a traced pass
over the profiled requests after the window. None where the program has no
such span."""


def read(r):
    crf = getattr(r, "crf", None)
    return crf.get("crf_ms") if crf else None
