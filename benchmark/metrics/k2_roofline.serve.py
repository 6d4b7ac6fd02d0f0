"""K2 (every kernel launched inside fgs.smooth_pass): its bound over its
device time in the traced window, in percent."""
from benchmark.readers import K2_ENTRY as ENTRY, k2_call_bound, kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, ENTRY, k2_call_bound)
