"""A configuration's deployment of the program: its settings, store, catalog
and service, built from the configuration file and the seed.

The service is the program's own ``InspectorApp`` on the card, run in
process as ``chip_smoke.py drive_service`` runs it: the program's ``FakeS3``
whose puts notify a ``FakeSQS`` queue once ``notify_on_put`` is called, the
poller thread receiving from it, the shared block dispatcher on, and
``Config`` at its defaults except for what the configuration file sets.
``MemoryS3`` keeps the bucket's objects in memory rather than in files: the
analyzer writes its own download copy of every upload, and files for the
bucket as well would double what a run writes to disk (about 1.5 GB a run
of the upload cell).

The catalog's fingerprint rows and timestamps go into the device corpus
through ``DeviceCorpus.append_fingerprints`` and ``upsert_timestamps``, and
its videos' rows into the in-memory store; the store's own restore path
(every fingerprint array parsed back) is not used for them. Videos a request
reads from the store (fragment-search sources) are stored with their
fingerprints and restored by the service at boot.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.device_corpus import DeviceCorpus
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.service import fakes
from tvidz_tpu_torch.service.app import InspectorApp


class MemoryS3(fakes.FakeS3):
    """``FakeS3`` with its objects in memory: its key check, events and
    chunked download as ``FakeS3`` has them."""

    def __init__(self, root: str):
        super().__init__(root)
        self._objects: Dict[str, bytes] = {}

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._objects[self._path(bucket, key)] = data
        self._emit_event(bucket, key)

    def download(self, bucket: str, key: str, local_path: str,
                 chunk_bytes: int = 8192) -> None:
        data = self._objects.get(self._path(bucket, key))
        if data is None:
            raise FileNotFoundError(f"s3://{bucket}/{key}")
        view = memoryview(data)
        with open(local_path, "wb") as f:
            for s in range(0, len(view), chunk_bytes):
                f.write(view[s:s + chunk_bytes])


def make_config(settings: Dict[str, dict], work_dir: str) -> Config:
    """``Config()`` with each ``settings[section][field]`` set, the store in
    memory and the analyzer's download copies under ``work_dir``."""
    cfg = Config()
    for section, fields in settings.items():
        part = getattr(cfg, section)
        for field, value in fields.items():
            if not hasattr(part, field):
                raise KeyError(f"Config.{section} has no field {field!r}")
            setattr(part, field, value)
    cfg.store.url = "sqlite:///:memory:"
    cfg.pipeline.tmp_dir = work_dir
    return cfg


class Deployment:
    """The program's service on ``device`` over a catalog."""

    def __init__(self, cfg: Config, device: str, work_dir: str):
        self.cfg = cfg
        self.store = Store(cfg.store.url)
        self.sqs = fakes.FakeSQS()
        self.s3 = MemoryS3(os.path.join(work_dir, "s3"))
        self.sqs.create_queue(cfg.service.sqs_queue)
        self.device = device
        self.app: Optional[InspectorApp] = None

    def notify_on_put(self) -> None:
        """From now on every put sends its S3 event to the service's queue."""
        self.s3.configure_notification(self.sqs, self.cfg.service.sqs_queue)

    @property
    def bucket(self) -> str:
        return self.cfg.service.s3_bucket

    def store_videos(self, names: Sequence[str],
                     fingerprints: Optional[Sequence[np.ndarray]] = None
                     ) -> List[int]:
        """Video rows (and their fingerprints) in the store, before boot."""
        vids = []
        for i, name in enumerate(names):
            v = self.store.add_video(name).id
            if fingerprints is not None:
                self.store.add_fingerprints(v, fingerprints[i])
            vids.append(v)
        return vids

    def boot(self) -> InspectorApp:
        m = self.cfg.match
        corpus = DeviceCorpus(max_cuts=m.max_cuts, words=self.cfg.hash.words,
                              hamming_threshold=m.hamming_threshold,
                              device=self.device)
        self.app = InspectorApp(config=self.cfg, store=self.store,
                                corpus=corpus, s3=self.s3, sqs=self.sqs,
                                device=self.device)
        self.client = self.app.wsgi.test_client()
        return self.app

    def load_catalog(self, vids: Sequence[int], rows: np.ndarray,
                     timestamps: Sequence[Sequence[float]]) -> None:
        """Each catalog video's rows and cut timestamps into the corpus."""
        corpus = self.app.corpus
        for i, v in enumerate(vids):
            corpus.append_fingerprints(v, rows[i])
            corpus.upsert_timestamps(v, timestamps[i])

    def stop(self) -> None:
        if self.app is not None:
            self.app.stop()
            t = self.app._poller_thread
            if t is not None:
                t.join(timeout=5)
