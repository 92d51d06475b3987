"""``crf_steps.<kind>``: the mean-field steps the program's fused CRF core
ran a request (``profiling.crf_steps()`` over a traced pass of the
profiled requests). None where the program has no such counter."""


def read(r):
    crf = getattr(r, "crf", None)
    return crf.get("steps") if crf else None
