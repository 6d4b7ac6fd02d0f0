"""The device clock of the window (benchmark/devclock.py) and the metric
that reads it, on the CPU: the union of intervals, the clock's reading as
a driver records it, and which runs start it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import devclock, harness


def test_union_length_counts_overlaps_once():
    assert devclock.union_length([]) == 0.0
    assert devclock.union_length([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert devclock.union_length([(5, 6), (0, 10), (2, 3)]) == 10.0
    assert devclock.union_length([(0, 1), (1, 2)]) == 2.0


def _event(device, start_ns, dur_ns):
    return SimpleNamespace(device_type=lambda: device, name=lambda: "k",
                           start_ns=lambda: start_ns,
                           duration_ns=lambda: dur_ns)


def test_only_the_cards_operations_count():
    result = SimpleNamespace(events=lambda: [
        _event(DeviceType.CUDA, 100, 50), _event(DeviceType.CPU, 0, 1000),
        _event(DeviceType.CUDA, 120, 100)])
    intervals = devclock._device_intervals(result)
    assert intervals == [(100, 150), (120, 220)]
    assert devclock.union_length(intervals) == 120


def test_the_clock_is_off_without_a_card():
    clock = devclock.DeviceClock("cpu", True)
    assert not clock.on
    clock.start()
    clock.stop()
    assert clock.busy_s is None and clock.operations == 0


def test_frame_device_ms_reads_the_clock():
    reader = harness.metric_reader("frame_device_ms")
    assert reader.WINDOW_DEVICE is True
    assert reader.read(SimpleNamespace(record={})) is None
    run = SimpleNamespace(record={"device_busy_s": 0.75, "device_items": 100})
    assert reader.read(run) == pytest.approx(7.5)


@pytest.mark.parametrize("cell, traced, wants", [
    ("stream432", False, True), ("serve432-b4", False, True),
    ("stream432", True, False), ("scan432", False, False),
    ("train-b16", False, False)])
def test_only_runs_that_read_the_card_start_the_clock(cell, traced, wants):
    """A traced run reads per-layer metrics only, and scan432's frame_ms
    is the host's clock: their windows run without the device clock."""
    manifest = harness.load_manifest()
    readers = [harness.metric_reader(m["name"])
               for m in harness.cell_metrics(manifest, cell, traced)]
    assert harness.wants_window_device(readers) is wants


class _FakeClock(devclock.DeviceClock):
    """Stands for the profiler: on, reading 0.5 s busy."""
    made = []

    def __init__(self, device, on):
        super().__init__(device, on)
        self.on, self.starts = on, 0
        _FakeClock.made.append(self)

    def start(self):
        if self.on:
            self.starts += 1
            self._prof = object()

    def stop(self):
        if self._prof is not None:
            self._prof, self.busy_s, self.copy_s = None, 0.5, 0.0


@pytest.mark.parametrize("cell", ["stream432", "serve432-b4"])
def test_a_driver_records_the_clock_over_every_item(tiny_bench, monkeypatch,
                                                    cell):
    monkeypatch.setattr(devclock, "DeviceClock", _FakeClock)
    _FakeClock.made.clear()
    root, bench = tiny_bench
    r = harness.run_cell(cell, 2**31 + 13, 1.5, False, "cpu", root=root,
                         bench_dir=bench)
    assert r["correct"], r["checks"]
    clock = _FakeClock.made[-1]
    assert clock.on and clock.starts == 1 and clock._prof is None
    items = 1e3 * clock.busy_s / r["metrics"]["frame_device_ms"]["value"]
    assert items == pytest.approx(round(items))
    # every item made under the clock counts, those past the window too
    assert round(items) >= r["attempted"]
    if cell == "stream432":
        assert round(items) <= r["attempted"] + 1
