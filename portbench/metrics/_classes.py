"""Shared by the readers of the profiled steps' kernel classes."""


def per_step_ms(rec, cls):
    p = rec.get("profile")
    if not p:
        return None
    return p["class_us"].get(cls, 0.0) / 1e3 / p["steps"]


def den_roofline(rec, cls):
    """Least time of the den pair (``portbench/flops``) over its device
    time a step, in percent; nothing where the pair did not run."""
    from portbench.peaks import H100_SXM

    p = rec.get("profile")
    f = rec["flops"]
    if not p or f["den_class"] != cls or not p["class_us"].get(cls):
        return None
    least = max(f["den_ops"] / H100_SXM["tf32_flops"],
                f["den_bytes"] / H100_SXM["hbm_bytes_per_s"])
    return 100.0 * least / (p["class_us"][cls] / 1e6 / p["steps"])
