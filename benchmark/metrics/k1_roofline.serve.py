"""K1 (every kernel launched inside cuda_corr.corr_fwd): its bound over
its device time in the traced window, in percent."""
from benchmark.readers import K1_ENTRY as ENTRY, k1_call_bound, kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, ENTRY, k1_call_bound)
