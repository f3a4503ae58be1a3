"""The Mamba2 state update's share of its roofline, in %: the least time
of the profiled steps' SSD decode steps (each layer's fp32 state read and
written once, x, dt, B and C read once, y written once, for the rows that
ran the layer), over the device time of the ``ssd_update`` kernel in the
profile.  Moves ``tokens_per_s``."""

from bench.work import counts

KERNELS = ("ssd_update",)


def read(run):
    prof = run.profile
    if not prof:
        return None
    dev_s = sum(t - s for n, s, t in prof["kernels"] if any(k in n for k in KERNELS)) * 1e-6
    if dev_s <= 0:
        return None
    m, split = run.model, run.split
    least = 0.0
    for st in run.stretch:
        for n_layers, rows in ((counts.mamba_layers(m, 0, split), st.live),
                               (counts.mamba_layers(m, split, m["num_layers"]), st.survivors)):
            if rows:
                least += n_layers * counts.least_seconds(*counts.ssd_update(m, rows), run.peaks)
    return 100.0 * least / dev_s
