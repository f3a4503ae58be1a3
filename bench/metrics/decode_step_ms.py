"""Median host milliseconds of the window's steps that admitted nothing
(each ends in its one device-to-host fetch).  Moves ``tokens_per_s``."""

import statistics


def read(run):
    ms = [(s.t1 - s.t0) * 1e3 for s in run.steps if not s.admitted]
    return statistics.median(ms) if ms else None
