"""The measured window: initial-conditions sets made back to back.

One IC is one call of ``toycluster_tpu_torch.pipeline.make_ics`` with the
harness's ``Recorder`` as its ``log``.  The window starts ICs while its
clock has not passed its length; every IC that starts also completes,
and every metric covers all of them whole.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class Recorder:
    """The ``log=`` callable of ``make_ics``: stamps the host clock at
    each call and keeps the stage name and its plain fields."""

    def __init__(self):
        self.records = []
        self.span_start = None   # host clock at the IC's span, if traced

    def __call__(self, stage, **fields):
        t = time.perf_counter()
        fields.pop("scene", None)
        self.records.append((t, stage, {
            k: v for k, v in fields.items()
            if isinstance(v, (bool, int, float, str, list, tuple))}))


@dataclass
class IC:
    """One completed initial-conditions set of the window."""
    t0: float                     # host clock before the call
    t1: float                     # host clock after it returned
    records: list                 # (t, stage, fields) of its stage log
    peak_bytes: int               # allocator peak of the call
    n_gas: int
    span_start: float = None      # host clock as its traced span began

    @property
    def seconds(self):
        return self.t1 - self.t0

    def stage(self, name):
        """The records of stage ``name``, each as (seconds since the
        record before it, or since the call began, and its fields)."""
        out, prev = [], self.t0
        for t, stage, fields in self.records:
            if stage == name:
                out.append((t - prev, fields))
            prev = t
        return out


@dataclass
class Run:
    """What the metric readers read: the window's ICs, the set-up time,
    the reference scene's ``judge.scene_facts``, and in a traced run the
    device trace (``devtrace.Trace``)."""
    ics: list
    setup_s: float
    facts: dict = field(default_factory=dict)
    trace: object = None

    def records(self, name):
        """Every record of stage ``name`` over the window's ICs, as
        (seconds since the record before it, fields)."""
        return [r for ic in self.ics for r in ic.stage(name)]


def run_window(make_ic, seconds, clock=time.perf_counter):
    """Call ``make_ic(recorder)`` back to back while the window's clock
    has not passed ``seconds``; ``make_ic`` returns (n_gas, peak bytes,
    result), or None where the IC failed, which ends the window.
    Returns the completed ICs and the last one's result."""
    ics, last = [], None
    start = clock()
    while not ics or clock() - start < seconds:
        rec = Recorder()
        last = None     # free the previous result before the next IC
        t0 = clock()
        got = make_ic(rec)
        if got is None:
            break
        n_gas, peak, last = got
        ics.append(IC(t0=t0, t1=clock(), records=rec.records,
                      peak_bytes=peak, n_gas=n_gas,
                      span_start=rec.span_start))
    return ics, last
