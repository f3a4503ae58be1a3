"""The whole window's share of the chip's roofline, in %: for every step
in the window, the least time its model work needs (each segment's
weights read once, its heads, the K/V and SSM state of the rows that ran
it; each admitted prompt's products, attention, weights and writes), summed
and divided by the window's seconds.  The counts do not depend on what
implements the work, so a kernel taken off the path cannot raise it.
Moves ``tokens_per_s``."""

from bench.work import counts


def read(run):
    m, split, peaks = run.model, run.split, run.peaks
    n_edge_heads = sum(1 for b in m["branch_layers"] if b < split)
    least = 0.0
    for st in run.steps:
        least += counts.least_seconds(*counts.segment(
            m, 0, split, st.live, st.edge_valid, n_edge_heads), peaks)
        if st.survivors:
            least += counts.least_seconds(*counts.segment(
                m, split, m["num_layers"], st.survivors, st.cloud_valid, 1), peaks)
        for p in st.admitted:
            least += counts.least_seconds(*counts.prefill(m, p), peaks)
    return 100.0 * least / run.seconds if run.steps else None
