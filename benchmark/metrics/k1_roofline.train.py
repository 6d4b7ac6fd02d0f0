"""K1 in training (every kernel launched inside cuda_corr.corr_fwd, the
recomputed forward included): bound over device time, in percent."""
from benchmark.readers import K1_ENTRY as ENTRY, k1_call_bound, kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, ENTRY, k1_call_bound)
