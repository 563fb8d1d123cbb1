"""Seconds an IC of the velocity stage's per-halo tables: the summed
seconds of the program's ``velocity_table`` spans (one a halo: the host
f(E) and potential tables and the speed CDFs), carried on the
``velocities`` record, over the window's ICs.  Moves ``ic_s``."""

from benchlib.spans import named, span_lists


def read(run):
    seconds = [s[i]["seconds"] for s in span_lists(run, "velocities")
               for i in named(s, "velocity_table")]
    return sum(seconds) / len(run.ics) if seconds else None
