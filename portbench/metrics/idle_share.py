"""Share of the profiled window (first kernel's start to the last one's
end) in which no kernel ran, copies and memsets apart: the union of the
kernels' spans (the method of ``chip_smoke._idle_share``)."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
