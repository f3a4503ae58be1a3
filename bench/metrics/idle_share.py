"""The device's idle share over the profiled stretch of steady steps: 1
minus the union of its operations' intervals over the stretch's length.
Moves ``tokens_per_s``."""

from bench.harness import trace


def read(run):
    prof = run.profile
    if not prof:
        return None
    lo, hi = prof["span"]
    return 1.0 - trace.busy_us(prof) / (hi - lo)
