"""The store-outage policy on the port: tests/test_store_outage.py's 15
tests — the transient-error classifier, critical writes retried and
skippable ones deferred to finalization, adoption of an INSERT whose ack was
lost, the supersede path through an outage, MiniPG's shutdown releasing the
write lock of a severed transaction, the service's whole-analysis retry,
and collective removes that fail against a down store — run unchanged
against the port's ``Analyzer``, ``Store``, ``create_app`` and MiniPG on the
CPU (``use_port``, tests/test_torch_event_wiring.py).
"""

import importlib

import pytest

from tests.test_torch_event_wiring import use_port

ref = importlib.import_module("tests.test_store_outage")


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)


env = ref.env

test_classifier = ref.test_classifier
test_verdict_writes_deferred_through_outage = ref.test_verdict_writes_deferred_through_outage
test_midstream_timestamp_writes_skipped_then_final = ref.test_midstream_timestamp_writes_skipped_then_final
test_checkpoint_save_outage_never_fails_analysis = ref.test_checkpoint_save_outage_never_fails_analysis
test_add_video_retries_through_brief_outage = ref.test_add_video_retries_through_brief_outage
test_add_video_permanent_outage_exhausts_retries = ref.test_add_video_permanent_outage_exhausts_retries
test_non_transient_error_propagates_immediately = ref.test_non_transient_error_propagates_immediately
test_add_video_retry_adopts_landed_insert = ref.test_add_video_retry_adopts_landed_insert
test_supersede_outage_no_self_duplicate_and_deferred_delete = ref.test_supersede_outage_no_self_duplicate_and_deferred_delete
test_minipg_shutdown_releases_write_lock = ref.test_minipg_shutdown_releases_write_lock
test_final_persist_retries_through_recovery = ref.test_final_persist_retries_through_recovery
test_service_level_whole_analysis_retry = ref.test_service_level_whole_analysis_retry
test_service_retry_skips_non_transient_analysis_errors = ref.test_service_retry_skips_non_transient_analysis_errors
test_collective_remove_failure_keeps_finalization_retry_path = ref.test_collective_remove_failure_keeps_finalization_retry_path
test_supersede_remove_failure_surfaces_transient = ref.test_supersede_remove_failure_surfaces_transient
