"""Dispatcher time per square: the journal stream rows' dispatch_ms, each batch counted once."""

from dabench.readers import journal_ms_per_square


def read(view):
    return journal_ms_per_square(view, "dispatch_ms")
