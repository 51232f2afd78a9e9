"""setup_s: process start to the end of warm-up (import, card, connect with
its index builds, every query text once), without the benchmark's own
data preparation."""


def read(rec):
    return rec.setup_s
