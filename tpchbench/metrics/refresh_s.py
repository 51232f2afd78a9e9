"""refresh_s: all seconds spent in RF1 and RF2 over the refresh functions
completed in the window."""


def read(rec):
    if not rec.refreshes:
        return None
    return sum(r[2] for r in rec.refreshes) / len(rec.refreshes)
