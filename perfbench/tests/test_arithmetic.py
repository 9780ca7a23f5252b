"""The end-to-end arithmetic and the least-time counts, against hand-worked
values."""

import math

import pytest

from perfbench import core, peaks


def test_percentile_over_all_samples():
    assert core.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.5
    assert core.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    assert core.percentile([7.0], 95) == 7.0


def test_failure_lies_beyond_every_percentile():
    values = [1.0] * 19 + [math.inf]
    assert core.percentile(values, 50) == 1.0
    assert math.isinf(core.percentile(values, 100))
    assert math.isinf(core.percentile([1.0, math.inf], 95))


def test_end_to_end_names():
    s = {"verdict": [1000.0, 3000.0], "search": [10.0]}
    assert core.end_to_end_value("verdict_p50_ms", s, 9.0) == 2000.0
    assert core.end_to_end_value("search_p95_ms", s, 9.0) == 10.0
    assert core.end_to_end_value("verdict_p50_s", s, 9.0) == 2.0
    assert core.end_to_end_value("setup_s", s, 9.0) == 9.0
    with pytest.raises(KeyError):
        core.end_to_end_value("ingest_frames_per_s", s, 9.0)


def test_k1_least_time():
    # 128 frames of 90x160 and one carry: 1,959,936 bytes (bound) against
    # 36,495,360 float32 operations.
    assert peaks.k1_bound_s([128], 90, 160) == pytest.approx(1959936 / 3.35e12)
    ops = 128 * (2 * 8 * 14400 + 2 * 64 * 90 + 3 * 14400)
    assert ops / 67e12 < peaks.k1_bound_s([128], 90, 160)
    assert peaks.k1_bound_s([128, 60], 90, 160) == pytest.approx(
        (188 * 14400 + 2 * 8 * 14400 + 188 * 12) / 3.35e12)


def test_scan_least_time():
    # 128 queries against 2^24 two-word rows: 2.749e11 int8 operations.
    assert peaks.scan_bound_s(128, 1 << 24, 2) == pytest.approx(
        2 * 32 * 2 * 128 * (1 << 24) / 1979e12)
    assert peaks.scan_bound_s(8, 1024, 2) == pytest.approx(
        (4 * 2 * 1032 + 64) / 3.35e12)


def test_align_least_time():
    ops = 2 * 32 * 8 * 800 * 8192
    assert peaks.align_ops([300, 500], [4096, 4096], 8) == ops
    assert peaks.align_bound_s([300, 500], [4096, 4096], 8) == pytest.approx(
        ops / 1979e12)
