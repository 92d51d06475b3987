"""``device_idle.<kind>``: the share of the profiled slice's wall time in
which no device operation ran, both read from the same trace, in %."""


def read(r):
    sl = r.slice
    if not sl or sl["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])
