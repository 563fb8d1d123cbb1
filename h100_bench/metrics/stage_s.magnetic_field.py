"""Seconds an IC of the magnetic-field stage (the vector potential and the
``stream_curl`` kernel): the gap between its stage record and the one
before it.  Moves ``ic_s``."""


def read(run):
    recs = run.records("magnetic_field")
    return sum(s for s, _ in recs) / len(run.ics) if recs else None
