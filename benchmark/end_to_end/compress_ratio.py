"""Input bytes over the bytes of the gzip members made, summed over every
call of the window."""


def read(window):
    member = sum(r.member for r in window.records)
    if not member:
        return None
    return sum(r.encoded for r in window.records) / member
