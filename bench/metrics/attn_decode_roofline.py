"""Decode attention's share of its roofline, in %: the least time the
profiled steps' decode attention needs (each attention layer's Q, the
valid K/V slots of each row that ran it, and its output, counted once),
over the device time of the kernels that implement it in the profile.
Moves ``tokens_per_s``."""

from bench.work import counts

#: Device operations whose names contain one of these implement decode
#: attention (the split and grouped routes of ``flash_decode`` and their
#: merges).
KERNELS = ("flash_decode",)


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
        for n_layers, valid, rows in (
                (counts.attn_layers(m, 0, split), st.edge_valid, st.live),
                (counts.attn_layers(m, split, m["num_layers"]), st.cloud_valid, st.survivors)):
            if rows:
                least += n_layers * counts.least_seconds(
                    *counts.attn_decode(m, valid, rows), run.peaks)
    return 100.0 * least / dev_s
