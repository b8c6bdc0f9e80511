"""Device kernels a step launches, from the profiled steps' trace."""


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    return p["kernels"] / p["steps"]
