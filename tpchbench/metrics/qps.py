"""qps: queries completed in the window over the window's seconds."""


def read(rec):
    if not rec.queries or rec.window_s <= 0:
        return None
    return len(rec.queries) / rec.window_s
