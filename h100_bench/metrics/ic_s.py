"""Seconds an initial-conditions set: the summed wall time of the window's
completed ICs over their count, from the config to the relaxed particle
set on the card.  Host clock."""


def read(run):
    return sum(ic.seconds for ic in run.ics) / len(run.ics)
