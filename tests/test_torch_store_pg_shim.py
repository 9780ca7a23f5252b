"""The ``Store``'s Postgres branch on the port through a fake ``psycopg2``
over sqlite: tests/test_store_pg_shim.py's 3 tests — every ``%s`` statement
executed, and the whole analyzer behind that store — run unchanged against
the port's ``Store`` and ``Analyzer`` on the CPU (``use_port``,
tests/test_torch_event_wiring.py).
"""

import importlib

import pytest

from tests.test_torch_event_wiring import use_port

ref = importlib.import_module("tests.test_store_pg_shim")


@pytest.fixture(autouse=True)
def _on_the_port(monkeypatch):
    use_port(monkeypatch, ref)


pg_store = ref.pg_store

test_pg_video_and_timestamp_paths = ref.test_pg_video_and_timestamp_paths
test_pg_fingerprint_and_checkpoint_paths = ref.test_pg_fingerprint_and_checkpoint_paths
test_pg_store_behind_full_analyzer = ref.test_pg_store_behind_full_analyzer
