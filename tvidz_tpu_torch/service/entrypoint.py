"""Process entrypoint of the port's inspector service.

Port of ``tvidz_tpu/service/entrypoint.py``: bootstrap the AWS resources
(queue with spin-wait retry, bucket, CORS, the S3 -> SQS notification), bind
and serve HTTP at once (``/healthz`` reports "warming"), warm the device on
the main thread — build every kernel, run one ``forward`` and one dispatcher
pass per batch bucket — then mark the app ready and start the SQS poller.

    python -m tvidz_tpu_torch.service.entrypoint --fake-aws \\
        --db sqlite:///:memory: --port 5055 [--device cuda|cpu] [--mesh]

``--mesh`` shards the corpus over every GPU of the host (one process,
``parallel.make_mesh`` and ``MeshCorpus``) where there are two or more, and
keeps the single-card corpus otherwise. ``--cells-per-device N`` repeats
each local device N times in either mesh: it is for emulation only (tests on
the CPU, or several ranks sharing one card), never a deployment.

Multi-host: with ``TVIDZ_COORDINATOR`` (``host:port`` of rank 0),
``TVIDZ_NUM_PROCESSES`` and ``TVIDZ_PROCESS_ID`` set, the process joins a
``torch.distributed`` group before its first device use (NCCL on CUDA, gloo
on the CPU or with ``TVIDZ_DIST_BACKEND=gloo``), and ``--mesh`` spans the
ranks: each shards its rows over its own devices (every visible card; the
CPU with ``--device cpu``), the corpus axis host-major, and every
corpus operation runs through the shared store's op log
(``parallel.collective``). Ranks share the durable store; each ingests its
own uploads and any rank serves verdicts and searches over the whole
corpus. N ranks on N cards run one per card (``CUDA_VISIBLE_DEVICES``);
ranks that share a card need ``TVIDZ_DIST_BACKEND=gloo``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from tvidz_tpu_torch import backend
from tvidz_tpu_torch.config import Config
from tvidz_tpu_torch.corpus.store import Store
from tvidz_tpu_torch.models.fingerprint import FingerprintModel
from tvidz_tpu_torch.ops.align import fragment_search
from tvidz_tpu_torch.ops.hamming import corpus_frame_min, corpus_query_nearest
from tvidz_tpu_torch.parallel.collective import (
    CollectiveRunner,
    MultiHostCorpusClient,
)
from tvidz_tpu_torch.parallel.distributed import (
    MultiHostShardedCorpus,
    init_distributed,
    make_multihost_mesh,
    process_count,
)
from tvidz_tpu_torch.parallel.mesh import make_mesh
from tvidz_tpu_torch.parallel.mesh_corpus import MeshCorpus
from tvidz_tpu_torch.pipeline.dispatcher import SharedBlockDispatcher
from tvidz_tpu_torch.service import fakes, wsgi
from tvidz_tpu_torch.service.app import create_app
from tvidz_tpu_torch.utils import log


def build_clients(config: Config, fake: bool, fake_root: str = None):
    if fake:
        if fake_root is None:
            fake_root = os.environ.get(
                "TVIDZ_FAKE_S3_ROOT",
                os.path.join(tempfile.gettempdir(), "tvidz-fake-s3"))
        sqs = fakes.FakeSQS()
        s3 = fakes.FakeS3(fake_root)
        sqs.create_queue(config.service.sqs_queue)
        s3.create_bucket(config.service.s3_bucket)
        s3.configure_notification(sqs, config.service.sqs_queue)
        return s3, sqs
    # The real clients need ``requests``, which the fakes do not.
    from tvidz_tpu_torch.service import aws as clients

    svc = config.service
    return (
        clients.S3Client(svc.s3_endpoint, region=svc.aws_region,
                         access_key=svc.aws_access_key,
                         secret_key=svc.aws_secret_key),
        clients.SQSClient(svc.effective_sqs_endpoint, svc.aws_region,
                          access_key=svc.aws_access_key,
                          secret_key=svc.aws_secret_key),
    )


def bootstrap(config: Config, s3, sqs, retries: int = 30,
              wait_s: float = 2.0) -> None:
    """Block until the queue is creatable, ensure the bucket, then apply
    bucket CORS and the s3:ObjectCreated:* -> SQS notification; each step
    is idempotent and best-effort, and a failure is logged."""
    queue_url = None
    for attempt in range(retries):
        try:
            queue_url = sqs.create_queue(config.service.sqs_queue)
            break
        except Exception as e:  # noqa: BLE001
            log("entrypoint",
                f"Waiting for SQS to be ready... (attempt {attempt+1}: {e})")
            time.sleep(wait_s)
    try:
        s3.create_bucket(config.service.s3_bucket)
    except Exception as e:  # noqa: BLE001
        log("entrypoint", f"bucket create failed (may already exist): {e}")
    try:
        s3.put_bucket_cors(config.service.s3_bucket)
        log("entrypoint", f"bucket CORS applied to '{config.service.s3_bucket}'")
    except Exception as e:  # noqa: BLE001
        log("entrypoint", f"bucket CORS apply failed: {e}")
    try:
        queue_arn = None
        if queue_url is not None:
            try:
                queue_arn = sqs.get_queue_arn(queue_url)
            except Exception:  # noqa: BLE001 — emulators without attributes
                pass
        if queue_arn is None:
            queue_arn = (f"arn:aws:sqs:{config.service.aws_region}:"
                         f"000000000000:{config.service.sqs_queue}")
        s3.put_bucket_notification(config.service.s3_bucket, queue_arn)
        log("entrypoint",
            f"s3:ObjectCreated:* -> {queue_arn} notification applied")
    except Exception as e:  # noqa: BLE001
        log("entrypoint", f"bucket notification apply failed: {e}")


def _warm_corpus_kernels(device, words: int) -> None:
    """One small launch of each corpus kernel a mesh shard runs (K4's two
    verdict modes, K3) on ``device``: its context and per-device kernel
    set-up happen at boot, not in the first query."""
    q = torch.zeros((8, words), dtype=torch.int32, device=device)
    rows = torch.zeros((256, words), dtype=torch.int32, device=device)
    corpus_frame_min(q, rows)
    corpus_query_nearest(q, rows)
    fragment_search(torch.zeros((64, words), dtype=torch.int32, device=device), 1,
                    rows.reshape(4, 64, words),
                    torch.ones((4,), dtype=torch.int32, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmup_device(config: Config, device, mesh=None) -> None:
    """Build every kernel (CUDA), run one forward at the production block
    shape, and one dispatcher pass at each batch bucket; with a ``mesh``,
    warm the corpus kernels on each of its devices too."""
    if device.type == "cuda":
        backend.build_all()
    for dev in mesh.distinct_devices if mesh is not None else ():
        _warm_corpus_kernels(dev, config.hash.words)
    model = FingerprintModel(config, device=device)
    scores, _, _ = model.forward(model.example_payload(), model.init_carry())
    scores.cpu()
    if config.pipeline.shared_dispatcher:
        SharedBlockDispatcher(model).warm()
    # example_payload is the production forward's shape in both modes (raw
    # luma, or projected coefficients under ship_dct_coeffs).
    log("entrypoint", f"device warm on {device}: kernels built, block shape "
                      + "x".join(str(d) for d in model.example_payload().shape)
                      + (" (coeff payloads)" if model.ship_coeffs else "")
                      + (" (+all batched buckets)"
                         if config.pipeline.shared_dispatcher else ""))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="tvidz_tpu_torch inspector service")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--db", default=None, help="store URL (sqlite:/// or postgresql://)")
    parser.add_argument("--s3-endpoint", default=None)
    parser.add_argument("--fake-aws", action="store_true",
                        help="in-process S3/SQS fakes (hermetic demo/test mode)")
    parser.add_argument("--no-poller", action="store_true")
    parser.add_argument("--mesh", action="store_true",
                        help="shard the corpus over every GPU of the host")
    parser.add_argument("--device", default=None,
                        help="cuda (default, or $TVIDZ_TORCH_DEVICE) or cpu")
    parser.add_argument("--cells-per-device", type=int, default=1,
                        help="emulation only: repeat each local device N "
                             "times in the --mesh mesh (default 1)")
    args = parser.parse_args(argv)
    device = backend.resolve_device(args.device)

    config = Config()
    # Thumbnails on by default in the service (library default is off).
    if not config.pipeline.thumbnail_dir:
        config.pipeline.thumbnail_dir = os.path.join(tempfile.gettempdir(),
                                                     "tvidz-thumbnails")
    if args.host:
        config.service.host = args.host
    if args.port:
        config.service.port = args.port
    if args.db:
        config.store.url = args.db
    if args.s3_endpoint:
        config.service.s3_endpoint = args.s3_endpoint

    s3, sqs = build_clients(config, args.fake_aws)
    if not args.fake_aws:
        bootstrap(config, s3, sqs)

    # Multi-host: join the torch.distributed group before first device use;
    # --mesh then spans the ranks (parallel/distributed.py).
    multihost = init_distributed(device=device)
    store = Store(config.store.url)
    corpus = mesh = runner = None
    if args.mesh:
        local = [d for d in ([torch.device("cuda", i)
                              for i in range(torch.cuda.device_count())]
                             if device.type == "cuda" else [device])
                 for _ in range(args.cells_per_device)]
        n = len(local) * process_count()
        if n < 2:
            log("entrypoint", f"--mesh requested but only {n} device; "
                              "falling back to single-chip corpus")
        elif multihost:
            # Every corpus operation — streaming ingest and queries — runs
            # as a collective launched by all ranks in the same order,
            # through the shared store's op log (parallel/collective.py).
            mesh = make_multihost_mesh(local_devices=local)
            mh = MultiHostShardedCorpus(
                mesh,
                max_cuts=config.match.max_cuts,
                words=config.hash.words,
                hamming_threshold=config.match.hamming_threshold,
                al_tcap=int(os.environ.get("TVIDZ_MH_AL_TCAP", "2048")),
            )
            runner = CollectiveRunner(
                store, mh,
                hamming_threshold=config.match.hamming_threshold,
                ts_capacity=int(
                    os.environ.get("TVIDZ_MH_TS_CAPACITY", "4096")),
                fp_capacity=int(
                    os.environ.get("TVIDZ_MH_FP_CAPACITY", str(1 << 18))),
                prune_interval_s=float(
                    os.environ.get("TVIDZ_MH_PRUNE_INTERVAL_S", "60")),
                wm_interval_s=float(
                    os.environ.get("TVIDZ_MH_WM_INTERVAL_S", "5")),
                lag_alarm_ops=int(
                    os.environ.get("TVIDZ_MH_LAG_ALARM_OPS", "1024")),
            )
            corpus = MultiHostCorpusClient(
                runner, max_cuts=config.match.max_cuts)
            device = mesh.home
            # Any rank answers /status for analyses that ran on another
            # (finished states live in the shared store).
            config.service.status_store_fallback = True
            log("entrypoint",
                f"multi-host cluster joined ({process_count()} hosts, "
                f"mesh {dict(mesh.shape)}); corpus sharded host-major, "
                "all ops via the collective log")
        else:
            mesh = make_mesh(devices=local)
            corpus = MeshCorpus(
                mesh,
                max_cuts=config.match.max_cuts,
                words=config.hash.words,
                hamming_threshold=config.match.hamming_threshold,
            )
            device = corpus.device
            log("entrypoint", f"corpus sharded over {n} devices "
                              f"(mesh {dict(mesh.shape)})")

    app = create_app(config=config, store=store,
                     corpus=corpus, s3=s3, sqs=sqs, device=device)
    app.collective_runner = runner
    app.device_ready = False
    # Serve at once (orchestrators see the port up, /healthz says
    # "warming"), then warm the device from the main thread.
    _server, thread = wsgi.start_server_thread(
        app.wsgi, config.service.host, config.service.port)
    log("entrypoint",
        f"inspector serving on {config.service.host}:{config.service.port} "
        "(device warming)")
    warmup_device(config, device, mesh)
    if runner is not None:
        # Warm placement and the cross-rank barrier; only the executor
        # loop runs on the runner's thread.
        runner.start()
    # /metrics counts the kernel launches of served work only.
    backend.reset_launch_counts()
    app.device_ready = True
    if not args.no_poller:
        app.start_poller()
    log("entrypoint", "inspector ready")
    thread.join()


if __name__ == "__main__":
    main()
