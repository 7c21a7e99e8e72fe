"""Uploader time per square: the journal stream rows' upload_ms, each batch counted once."""

from dabench.readers import journal_ms_per_square


def read(view):
    return journal_ms_per_square(view, "upload_ms")
