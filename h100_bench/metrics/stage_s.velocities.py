"""Seconds an IC of the velocities stage (mostly the host f(E) tables, one
per halo): the gap between its stage record and the one before it.
Moves ``ic_s``."""


def read(run):
    recs = run.records("velocities")
    return sum(s for s, _ in recs) / len(run.ics) if recs else None
