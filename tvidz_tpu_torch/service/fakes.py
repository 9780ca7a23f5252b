"""In-process S3/SQS test doubles with the service.aws client interfaces.

The role LocalStack plays in the reference's test strategy (SURVEY.md §4:
the whole AWS control plane in one container) — here in one process, with
the same at-least-once + event-notification semantics, so the full
upload -> event -> analysis -> verdict path runs hermetically.
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import shutil
import threading
import urllib.parse
import uuid
from typing import Dict, List, Optional


class FakeS3:
    """Directory-backed S3 with optional put-event notification to a FakeSQS
    queue (the LS_S3_WEBHOOKS / s3-event-config role, docker-compose.yaml:14)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._notify_sqs: Optional["FakeSQS"] = None
        self._notify_queue: Optional[str] = None

    def configure_notification(self, sqs: "FakeSQS", queue_name: str) -> None:
        self._notify_sqs = sqs
        self._notify_queue = queue_name

    def _path(self, bucket: str, key: str) -> str:
        # Keys arrive from unauthenticated /notify and SQS events; reject
        # any key that resolves outside the bucket root (e.g. '../../etc/..')
        # so a crafted event can't read arbitrary host files.
        bucket_root = os.path.realpath(os.path.join(self.root, bucket))
        path = os.path.realpath(os.path.join(bucket_root, key))
        if path != bucket_root and not path.startswith(bucket_root + os.sep):
            raise PermissionError(f"key escapes bucket root: {key!r}")
        return path

    def create_bucket(self, bucket: str) -> None:
        os.makedirs(os.path.join(self.root, bucket), exist_ok=True)

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        path = self._path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        self._emit_event(bucket, key)

    def put_file(self, bucket: str, key: str, src_path: str) -> None:
        path = self._path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copy(src_path, path)
        self._emit_event(bucket, key)

    def _emit_event(self, bucket: str, key: str) -> None:
        if self._notify_sqs is None:
            return
        # Real S3 URL-encodes object keys in event notifications (space
        # becomes '+', '%' becomes '%25'; '/' is kept) — the service decodes
        # with unquote_plus (app.py _decode_event_key). Emitting the raw key
        # here would corrupt names containing '%' or '+' on the fake path.
        encoded_key = urllib.parse.quote_plus(key, safe="/")
        # Real S3 stamps each record with its event time, ISO 8601 UTC to
        # the millisecond ("2026-10-17T23:06:39.123Z").
        now = datetime.datetime.now(datetime.timezone.utc)
        event = {
            "Records": [
                {"eventTime": now.strftime("%Y-%m-%dT%H:%M:%S.")
                              + f"{now.microsecond // 1000:03d}Z",
                 "s3": {"bucket": {"name": bucket},
                        "object": {"key": encoded_key}}}
            ]
        }
        url = self._notify_sqs.get_or_create_queue(self._notify_queue)
        self._notify_sqs.send(url, json.dumps(event))

    def download(self, bucket: str, key: str, local_path: str,
                 chunk_bytes: int = 8192) -> None:
        src = self._path(bucket, key)
        if not os.path.exists(src):
            raise FileNotFoundError(f"s3://{bucket}/{key}")
        with open(src, "rb") as fin, open(local_path, "wb") as fout:
            while True:
                chunk = fin.read(chunk_bytes)
                if not chunk:
                    break
                fout.write(chunk)


class FakeSQS:
    """At-least-once in-memory SQS: messages stay in flight until deleted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: Dict[str, "queue.Queue[dict]"] = {}
        self._inflight: Dict[str, dict] = {}

    def _q(self, url: str) -> "queue.Queue[dict]":
        with self._lock:
            if url not in self._queues:
                raise RuntimeError(f"NonExistentQueue: {url}")
            return self._queues[url]

    def get_queue_url(self, name: str) -> str:
        url = f"fake-sqs://{name}"
        with self._lock:
            if url not in self._queues:
                raise RuntimeError(f"NonExistentQueue: {name}")
        return url

    def create_queue(self, name: str) -> str:
        url = f"fake-sqs://{name}"
        with self._lock:
            self._queues.setdefault(url, queue.Queue())
        return url

    def get_or_create_queue(self, name: str, retries: int = 10,
                            wait_s: float = 0.0) -> str:
        return self.create_queue(name)

    def send(self, queue_url: str, body: str) -> None:
        self._q(queue_url).put({"Body": body})

    def receive(self, queue_url: str, wait_s: int = 10,
                max_messages: int = 1) -> List[dict]:
        q = self._q(queue_url)
        out = []
        try:
            # Short timeout keeps test polling snappy; semantics match
            # long-poll (block up to wait, return up to max_messages).
            msg = q.get(timeout=min(wait_s, 0.05))
        except queue.Empty:
            return out
        handle = uuid.uuid4().hex
        with self._lock:
            self._inflight[handle] = msg
        out.append({"Body": msg["Body"], "ReceiptHandle": handle})
        return out

    def delete(self, queue_url: str, receipt_handle: str) -> None:
        with self._lock:
            self._inflight.pop(receipt_handle, None)

    def requeue_inflight(self) -> int:
        """Simulate visibility timeout expiry: put undeleted messages back.
        (Fault-injection hook for at-least-once tests.)"""
        with self._lock:
            items = list(self._inflight.values())
            self._inflight.clear()
            # Single-queue assumption: the inspector uses exactly one queue.
            q = next(iter(self._queues.values()), None)
        if q is not None:
            for m in items:
                q.put(m)
        return len(items)
