"""``crf_roofline.<kind>``: over the profiled requests, the summed least
time (``bounds.bound_of``) of the CRF core's K9 (``crf_operator``) and K10
(``crf_iterate``) calls over their device time, in %
(``kernel_trace.bounds_and_time``)."""


def read(r):
    crf = getattr(r, "crf", None)
    if not crf or not crf["calls"] or crf["device_s"] <= 0:
        return None
    return 100.0 * crf["bound_s"] / crf["device_s"]
