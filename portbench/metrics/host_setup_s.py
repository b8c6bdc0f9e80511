"""Seconds of the host set-up (corpus, tree, den, chunks), from the
harness's span around the calls into the port's set-up."""


def read(rec):
    return rec["spans"].get("host_setup_s")
