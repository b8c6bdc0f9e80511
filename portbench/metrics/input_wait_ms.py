"""Mean host milliseconds a window step waits in ``next()`` for its
batch from the loader and the prefetcher; nothing where the batches sit
on the card."""


def read(rec):
    waits = rec.get("wait_s") or []
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
