"""The first-party Postgres wire driver against MiniPG, on the port:
tests/test_pgwire.py's 12 tests — md5, SCRAM-SHA-256 and cleartext auth,
every ``Store`` statement over real TCP, the collective op log's statements,
the whole analyzer writing through the wire, the RFC 7677 vectors, the
parameter and result codecs, placeholder conversion, framing, and the
store's reconnect after a server restart — run unchanged against the port's
``corpus.pgwire``, ``service.minipg``, ``Store`` and ``Analyzer`` on the
CPU (``use_port``, tests/test_torch_event_wiring.py).
"""

import importlib

import pytest

from tests.test_torch_event_wiring import use_port

ref = importlib.import_module("tests.test_pgwire")


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)


server = ref.server
store = ref.store

test_md5_auth_and_bad_password = ref.test_md5_auth_and_bad_password
test_scram_sha256_auth_full_exchange = ref.test_scram_sha256_auth_full_exchange
test_cleartext_auth = ref.test_cleartext_auth
test_store_video_roundtrip_over_the_wire = ref.test_store_video_roundtrip_over_the_wire
test_store_timestamps_fingerprints_checkpoints = ref.test_store_timestamps_fingerprints_checkpoints
test_store_collective_ops_over_the_wire = ref.test_store_collective_ops_over_the_wire
test_full_analyzer_run_over_the_wire = ref.test_full_analyzer_run_over_the_wire
test_scram_client_against_rfc7677_vectors = ref.test_scram_client_against_rfc7677_vectors
test_param_and_result_codecs_roundtrip = ref.test_param_and_result_codecs_roundtrip
test_placeholder_conversion_respects_literals = ref.test_placeholder_conversion_respects_literals
test_buf_rejects_negative_payload_length = ref.test_buf_rejects_negative_payload_length
test_store_reconnects_after_server_restart = ref.test_store_reconnects_after_server_restart
