"""K3 and K2b (every kernel launched inside cuda_corr.corr_bwd): their
summed bounds over their device time, in percent."""
from benchmark.readers import CORR_BWD_ENTRY as ENTRY, corr_bwd_call_bound, kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, ENTRY, corr_bwd_call_bound)
