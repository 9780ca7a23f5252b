"""The port's bench: the ingest legs of ``bench.py`` at tiny sizes on the CPU.

``python -m tvidz_tpu_torch bench --device cpu --sizes tiny`` runs every
leg here; its record must carry every key of ``bench.py``'s record (each
either a value or null with its reason in ``why_null``), with the host-clock
numbers of a CPU run under ``host`` and never under a device key. The legs
that decode MJPEG need the port's native libav decoder and skip without it,
with its reason. The service leg repeats its phases until two agree within
15% and reports the last; fixtures live in a directory of the process and
are moved into place whole.
"""

import json
import os
import re
from pathlib import Path

import pytest

from tvidz_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    os.environ.setdefault("TVIDZ_LOG_LEVEL", "WARNING")
    return bench.run("cpu", "tiny", bench.LEGS)


def _reference_keys():
    """The keys bench.py's main() writes into its record (its CPU-fallback
    marker aside)."""
    text = (ROOT / "bench.py").read_text()
    keys = set(re.findall(r'record\["([a-z0-9_]+)"\]', text))
    start = text.index("record = {")
    keys |= set(re.findall(r'^\s+"([a-z_]+)": ', text[start:text.index("}", start)],
                           re.M))
    return keys - {"cpu_fallback"}


def test_record_has_every_key_of_the_reference(record):
    want = _reference_keys()
    assert len(want) == 34
    assert want <= set(bench.RECORD_KEYS) | {"metric", "unit", "device_only"}
    assert want <= set(record)
    assert record["metric"] == "1080p_frames_fingerprinted_per_sec_per_chip"
    assert record["unit"] == "frames/s" and record["device_only"] is True
    for key in bench.RECORD_KEYS:
        if record[key] is None:
            assert record["why_null"].get(key), f"{key} is null with no reason"


def test_cpu_numbers_are_never_device_keys(record):
    """Off the card every measured rate sits under host, and its device
    key is null with that reason."""
    host = record["host"]
    for key in ("value", "e2e_streams_y4m_frames_per_sec",
                "service_e2e_y4m_blocks_per_pass", "batched_clips_frames_per_sec"):
        assert key in host and record.get(key) is None
        assert "device cpu" in record["why_null"][key]
    assert set(host["e2e_streams_y4m_frames_per_sec"]) == {"1", "2"}
    assert record["boot_restore_1m_s"] > 0
    assert record["batched_clips_k1_launches_per_call"] == 0


def test_service_leg_reports_its_plateau(record):
    phases = record["host"]["service_e2e_y4m_phases_videos_per_min"]
    assert 2 <= len(phases) <= bench.SIZES["tiny"]["service_phases"]
    assert record["host"]["service_e2e_y4m_videos_per_min"] == phases[-1]
    if len(phases) < bench.SIZES["tiny"]["service_phases"]:
        assert abs(phases[-1] / phases[-2] - 1) < 0.15
    stages = record["host"]["service_e2e_y4m_stages"]
    assert stages["fingerprint"]["n"] == bench.SIZES["tiny"]["y4m_service"][0]


def test_record_names_the_decoders_here(record):
    """The probe of what writes and decodes the fixtures is in the record,
    and agrees with the reason the libav legs give."""
    probe = record["host"]["decoders"]
    assert set(probe) == {"native_libav", "pkg_config_libavcodec", "ffmpeg",
                          "PIL", "cv2"}
    assert probe["native_libav"] == (bench._native_or_reason() is None)


def test_libav_legs_run_or_say_why(record):
    why = bench._native_or_reason()
    if why:
        for key in ("decode_only_frames_per_sec", "e2e_decoded_frames_per_sec",
                    "e2e_streams_frames_per_sec_dcskim_coeff",
                    "service_e2e_fast_frames_per_sec"):
            assert record[key] is None and why in record["why_null"][key]
        pytest.skip(why)
    host = record["host"]
    for key in ("e2e_decoded_frames_per_sec", "e2e_decoded_frames_per_sec_dcskim_coeff",
                "vs_baseline_e2e_fast", "service_e2e_blocks_per_pass",
                "service_e2e_fast_frames_per_sec"):
        assert host[key] > 0, key
    for suffix in ("", "_fast", "_dcskim", "_dcskim_coeff"):
        assert set(host[f"e2e_streams_frames_per_sec{suffix}"]) == {"1", "2"}
    assert record["decode_only_frames_per_sec"]["mjpeg_dcskim"] > 0


def test_fixtures_are_per_process_and_whole(tmp_path):
    calls = []

    def write(path):
        calls.append(path)
        assert ".part" in os.path.basename(path)
        Path(path).write_bytes(b"x" * 10)

    p = bench._fixture("probe.avi", write)
    assert f"tvidz-bench-{os.getpid()}-" in p and p.endswith("probe.avi")
    assert Path(p).read_bytes() == b"x" * 10
    assert bench._fixture("probe.avi", write) == p and len(calls) == 1
    assert not [f for f in os.listdir(os.path.dirname(p)) if ".part" in f]


def test_cli_prints_the_card_line_then_the_record(capsys):
    assert bench.main(["--device", "cpu", "--sizes", "tiny",
                       "--legs", "boot_restore"]) == 0
    card, line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert card.startswith("no CUDA card")
    assert json.loads(line)["why_null"]["e2e_streams_frames_per_sec"] == (
        "leg 'e2e_scaling' not run")
