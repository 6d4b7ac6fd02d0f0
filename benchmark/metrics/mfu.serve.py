"""Model FLOPs of the frames the traced steps served over the device's
busy time in the trace, against 165 TFLOP/s, in percent."""
from benchmark.readers import frame_mfu_pct as read  # noqa: F401
