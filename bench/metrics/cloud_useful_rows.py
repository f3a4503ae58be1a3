"""Survivors over bucket rows, summed over the window's cloud segment
calls (``StepReport.compaction``): the useful share of the compacted
cloud work.  Moves ``tokens_per_s``."""


def read(run):
    rows = sum(s.bucket for s in run.steps)
    return sum(s.survivors for s in run.steps) / rows if rows else None
