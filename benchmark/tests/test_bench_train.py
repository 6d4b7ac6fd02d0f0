"""The training cell end to end on the CPU (tiny_bench: batch 2 of
64x128): the run is correct, and a fault planted in the timed path makes
it incorrect: a step that leaves the parameters unchanged, or one that
leaves half of the batch out and takes its means over the rest; a loader
that hands out one batch again and again, or blank exemplars."""

import pytest


def _run(tiny_bench, seed=2**31 + 3):
    from benchmark import harness

    root, bench = tiny_bench
    return harness.run_cell("train-b16", seed, 8.0, False, "cpu", root=root,
                            bench_dir=bench)


def test_a_cpu_run_of_the_training_cell_is_correct(tiny_bench):
    r = _run(tiny_bench)
    assert r["correct"], r["checks"]
    assert {"setup_s"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "batch_repeated", "blank_reference"])
def test_a_fault_in_the_training_step_makes_the_run_incorrect(
        tiny_bench, monkeypatch, fault):
    from devc_tpu_torch.data import videoloader
    from devc_tpu_torch.train import loop

    if fault == "batch_repeated":
        orig_iter = videoloader.PrefetchLoader.__iter__

        def repeated(self):
            first = next(orig_iter(self))
            while True:
                yield first

        monkeypatch.setattr(videoloader.PrefetchLoader, "__iter__", repeated)
    elif fault == "blank_reference":
        orig_get = videoloader.ImageNetPairsDataset.get

        def blank(self, index, rng):
            item = orig_get(self, index, rng)
            item["ref_rgb"] = item["ref_rgb"] * 0
            return item

        monkeypatch.setattr(videoloader.ImageNetPairsDataset, "get", blank)
    elif fault == "state_unchanged":
        monkeypatch.setattr(loop, "apply_updates", lambda module, upd: None)
    else:
        orig = loop.preprocess_batch_u8

        def half(batch_u8):
            rows = next(iter(batch_u8.values())).shape[0] // 2
            return orig({k: v[:rows] for k, v in batch_u8.items()})

        monkeypatch.setattr(loop, "preprocess_batch_u8", half)
    r = _run(tiny_bench)
    assert not r["correct"], r["checks"]
