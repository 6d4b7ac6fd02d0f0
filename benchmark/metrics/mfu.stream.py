"""Model FLOPs of the traced frames over the device's busy time in the
trace, against 165 TFLOP/s (fp32-accurate products as three TF32 passes),
in percent."""
from benchmark.readers import frame_mfu_pct as read  # noqa: F401
