"""Fault injection on the port's ingestion loop: tests/test_fault_tolerance.py's
3 tests — the SQS poller through receive errors and malformed messages, and
the stage timer with profiling on — run unchanged against the port's
``create_app`` and ``utils.timing`` on the CPU (``use_port``,
tests/test_torch_event_wiring.py).
"""

import importlib

import pytest

from tests.test_torch_event_wiring import use_port

ref = importlib.import_module("tests.test_fault_tolerance")


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)

test_poller_survives_receive_errors = ref.test_poller_survives_receive_errors
test_malformed_sqs_message_not_deleted_blindly = ref.test_malformed_sqs_message_not_deleted_blindly
test_stage_timer_and_profiler_annotation = ref.test_stage_timer_and_profiler_annotation
