"""Device ms per output frame: the card's busy time over the window (the
union of its kernel, copy and fill intervals, benchmark/devclock.py) over
the frames it made there, whatever the host's pace."""

WINDOW_DEVICE = True  # the driver runs the device clock over the window


def read(run):
    busy, items = (run.record.get("device_busy_s"),
                   run.record.get("device_items"))
    if not busy or not items:
        return None
    return 1e3 * busy / items
