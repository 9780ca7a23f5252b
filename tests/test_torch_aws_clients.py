"""The S3/SQS HTTP clients on the port: tests/test_aws_clients.py's 6
tests — against its in-process mock endpoints speaking the S3 REST and SQS
query protocols, and the service's poll loop through the real SQS client —
run unchanged against the port's ``service.aws`` and ``create_app`` on the
CPU (``use_port``, tests/test_torch_event_wiring.py).
"""

import importlib

import pytest

from tests.test_torch_event_wiring import use_port

ref = importlib.import_module("tests.test_aws_clients")


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)


mock_aws = ref.mock_aws

test_s3_put_and_streamed_download = ref.test_s3_put_and_streamed_download
test_s3_download_missing_raises = ref.test_s3_download_missing_raises
test_sqs_roundtrip = ref.test_sqs_roundtrip
test_sqs_get_or_create_retries_nonexistent = ref.test_sqs_get_or_create_retries_nonexistent
test_sqs_unknown_queue_raises = ref.test_sqs_unknown_queue_raises
test_poll_loop_with_real_wire_client = ref.test_poll_loop_with_real_wire_client
