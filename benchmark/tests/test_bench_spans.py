"""The metrics that read the program's own counters, on fabricated passes,
and the idle-gap labels taken from the program's spans."""

import pytest

from conftest import ROOT
from harness import gaps
from harness.manifest import Manifest

COUNTERS = {
    "launch_wait_ingest_ms_per_kread": ("wait_ingest_s",),
    "launch_wait_tail_ms_per_kread": ("wait_tail_s",),
    "ingest_prep_ms_per_kread": ("prep_s",),
    "aligner_setup_ms_per_kread": ("aligner_setup_s",),
    "host_tail_cpu_pct": ("tail_cpu_s",),
}
PASS = {"reduce_s": 1.0, "verify_emit_s": 0.5, "residue_s": 0.5, "tail_cpu_s": 1.2,
        "wait_ingest_s": 0.01, "wait_tail_s": 0.4, "prep_s": 0.3, "aligner_setup_s": 0.05,
        "submit_s": 0.2, "drain_s": 0.1}


def _ctx(stage_times, passes=2, reads=240_000):
    return {"passes": [{"stage_times": dict(stage_times)} for _ in range(passes)],
            "reads": reads}


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_reads_the_program_counter(metric):
    mod = Manifest(ROOT).reader(metric)
    got = mod.read(_ctx(PASS))
    if metric == "host_tail_cpu_pct":
        assert got == pytest.approx(60.0)
    else:
        (key,) = COUNTERS[metric]
        assert got == pytest.approx(1e6 * 2 * PASS[key] / 240_000)


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_absent_counters_read_nothing(metric):
    """A program without the counter (the parent of the change that added
    it) gives no number, and no error."""
    mod = Manifest(ROOT).reader(metric)
    (key,) = COUNTERS[metric]
    assert mod.read(_ctx({k: v for k, v in PASS.items() if k != key})) is None
    assert mod.read(_ctx({})) is None
    assert mod.read({"passes": [], "reads": 0}) is None


MAIN, POOL = 1, 2
HOST = [("pass.align", 0.0, 10_000.0), ("host_tail", 1_000.0, 9_950.0),
        ("ingest", 500.0, 1_500.0)]


def test_gap_under_the_launch_threads_wait_is_named_by_it():
    program = [
        ("align.run", None, MAIN, 0.0, 10_000.0, 0),
        ("phase_a.submit", 3, MAIN, 900.0, 1_000.0, 0),
        ("launch.wait_tail", 2, MAIN, 1_000.0, 8_000.0, 0),
        ("tail.collect", 2, POOL, 1_000.0, 9_000.0, 0),
        ("gc", None, POOL, 7_800.0, 8_600.0, 0),
    ]
    got = gaps.label([(1_000.0, 7_000.0), (7_500.0, 8_600.0), (9_100.0, 9_900.0)],
                     HOST, program)
    assert got == [["launch.wait_tail", 0.006], ["gc", 0.0011],
                   ["host_tail", pytest.approx(0.0008)]]


def test_without_program_spans_the_labels_are_the_harness_rule():
    got = gaps.label([(1_200.0, 2_000.0), (200.0, 400.0), (-50.0, -10.0)], HOST)
    assert got == [["host_tail", pytest.approx(0.0008)], ["pass.align", 0.0002],
                   ["idle", pytest.approx(0.00004)]]
