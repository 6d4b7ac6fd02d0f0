"""Model FLOPs of the traced training steps (no recomputation counted)
over the device's busy time in the trace, against 165 TFLOP/s, in
percent."""
from benchmark.readers import train_mfu_pct as read  # noqa: F401
