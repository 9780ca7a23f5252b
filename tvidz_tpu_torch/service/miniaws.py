"""MiniAWS — an in-process HTTP S3+SQS emulator on the first-party WSGI
stack.

This fills the role LocalStack plays in the reference's test strategy
(SURVEY.md §4: the whole AWS control plane in one container,
docker-compose.yaml:4-19) without a container: it speaks enough of the S3
REST API and the SQS query protocol that the REAL clients in service/aws.py
run against it unmodified — bucket create, object GET/PUT, bucket CORS and
notification subresources, SigV4 *presigned* PUT with full signature
validation, CORS preflight, and S3->SQS ObjectCreated events with
URL-encoded keys (exactly what drives the reference's analysis pipeline,
s3-event-config.json + entrypoint.sh:31-44).

Storage/queue semantics are delegated to the service.fakes doubles, so the
fake and HTTP paths cannot drift apart.
"""

from __future__ import annotations

import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from typing import Dict, Optional

from tvidz_tpu_torch.service import sigv4
from tvidz_tpu_torch.service.fakes import FakeS3, FakeSQS
from tvidz_tpu_torch.service.wsgi import App, Request, Response

_SQS_NS = "http://queue.amazonaws.com/doc/2012-11-05/"


def _xml(tag: str, inner: str) -> str:
    return (
        f'<?xml version="1.0"?><{tag} xmlns="{_SQS_NS}">{inner}'
        f"<ResponseMetadata><RequestId>{uuid.uuid4().hex}</RequestId>"
        f"</ResponseMetadata></{tag}>"
    )


def _escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;"))


class MiniAWS:
    """One emulated region: S3 buckets + SQS queues behind one endpoint."""

    ACCOUNT = "000000000000"

    def __init__(self, root_dir: str, region: str = "us-east-1",
                 secret_key: str = "test", strict_auth: bool = False):
        self.s3 = FakeS3(root_dir)
        self.sqs = FakeSQS()
        self.region = region
        self.secret_key = secret_key
        # strict_auth: presigned requests are ALWAYS validated; when strict,
        # every non-presigned request (S3 object GET/PUT, bucket ops, SQS)
        # must carry a SigV4 Authorization header too (real-AWS behavior;
        # LocalStack is lax) — so a client regressing to unsigned requests
        # fails in tests, not on AWS.
        self.strict_auth = strict_auth
        self.cors: Dict[str, str] = {}           # bucket -> raw XML
        self.notification: Dict[str, str] = {}   # bucket -> raw XML
        self.app = self._build()
        self._base_url: Optional[str] = None

    # -- helpers ---------------------------------------------------------------

    def queue_url(self, name: str) -> str:
        base = self._base_url or "http://miniaws"
        return f"{base}/{self.ACCOUNT}/{name}"

    def queue_arn(self, name: str) -> str:
        return f"arn:aws:sqs:{self.region}:{self.ACCOUNT}:{name}"

    def set_base_url(self, url: str) -> None:
        """Outward-facing endpoint (for queue URLs), set once served."""
        self._base_url = url.rstrip("/")

    def _header_auth_ok(self, request: Request) -> bool:
        return request.environ.get("HTTP_AUTHORIZATION", "").startswith(
            "AWS4-HMAC-SHA256"
        )

    def _validate_presign(self, request: Request, bucket: str, key: str):
        q = request.query
        host = request.environ.get("HTTP_HOST", "miniaws")
        path = f"/{bucket}/" + urllib.parse.quote(key, safe="-_.~/")
        return sigv4.validate_presigned(
            method=request.method, host=host, path=path, query=q,
            secret_key=self.secret_key,
        )

    def _apply_notification_xml(self, bucket: str, xml_body: str) -> None:
        """Parse NotificationConfiguration and wire S3 put events to the
        named queue — the actual event plumbing the reference's
        put-bucket-notification-configuration call installs."""
        root = ET.fromstring(xml_body)
        queue_name = None
        for qc in root.iter():
            if qc.tag.endswith("Queue") and (qc.text or "").startswith("arn:"):
                queue_name = qc.text.rsplit(":", 1)[-1]
        if queue_name:
            self.sqs.create_queue(queue_name)
            self.s3.configure_notification(self.sqs, queue_name)
        self.notification[bucket] = xml_body

    # -- SQS query protocol -------------------------------------------------------

    def _sqs_dispatch(self, request: Request, queue_name: Optional[str]) -> Response:
        if self.strict_auth and not self._header_auth_ok(request):
            return Response(_xml(
                "ErrorResponse",
                "<Error><Code>MissingAuthenticationToken</Code></Error>"),
                status=403, mimetype="text/xml")
        form = {
            k: v[0] for k, v in urllib.parse.parse_qs(
                request.body.decode("utf-8"), keep_blank_values=True
            ).items()
        }
        action = form.get("Action", "")
        url = self.queue_url(queue_name) if queue_name else None
        try:
            if action == "CreateQueue":
                u = self.queue_url(form["QueueName"])
                self.sqs.create_queue(form["QueueName"])
                return Response(_xml(
                    "CreateQueueResponse",
                    f"<CreateQueueResult><QueueUrl>{u}</QueueUrl>"
                    f"</CreateQueueResult>"), mimetype="text/xml")
            if action == "GetQueueUrl":
                name = form["QueueName"]
                try:
                    self.sqs.get_queue_url(name)
                except RuntimeError:
                    return Response(_xml(
                        "ErrorResponse",
                        "<Error><Code>AWS.SimpleQueueService.NonExistentQueue"
                        "</Code></Error>"), status=400, mimetype="text/xml")
                return Response(_xml(
                    "GetQueueUrlResponse",
                    f"<GetQueueUrlResult><QueueUrl>{self.queue_url(name)}"
                    f"</QueueUrl></GetQueueUrlResult>"), mimetype="text/xml")
            if action == "GetQueueAttributes":
                arn = self.queue_arn(queue_name or "")
                return Response(_xml(
                    "GetQueueAttributesResponse",
                    "<GetQueueAttributesResult><Attribute>"
                    f"<Name>QueueArn</Name><Value>{arn}</Value>"
                    "</Attribute></GetQueueAttributesResult>"),
                    mimetype="text/xml")
            if action == "SendMessage":
                self.sqs.send(self.sqs.get_queue_url(queue_name),
                              form["MessageBody"])
                return Response(_xml(
                    "SendMessageResponse", "<SendMessageResult>"
                    "<MessageId>m-1</MessageId></SendMessageResult>"),
                    mimetype="text/xml")
            if action == "ReceiveMessage":
                msgs = self.sqs.receive(
                    self.sqs.get_queue_url(queue_name),
                    wait_s=int(form.get("WaitTimeSeconds", "0")),
                    max_messages=int(form.get("MaxNumberOfMessages", "1")),
                )
                inner = "".join(
                    "<Message>"
                    f"<MessageId>m-{i}</MessageId>"
                    f"<ReceiptHandle>{m['ReceiptHandle']}</ReceiptHandle>"
                    f"<Body>{_escape(m['Body'])}</Body>"
                    "</Message>"
                    for i, m in enumerate(msgs)
                )
                return Response(_xml(
                    "ReceiveMessageResponse",
                    f"<ReceiveMessageResult>{inner}</ReceiveMessageResult>"),
                    mimetype="text/xml")
            if action == "DeleteMessage":
                self.sqs.delete(self.sqs.get_queue_url(queue_name),
                                form["ReceiptHandle"])
                return Response(_xml(
                    "DeleteMessageResponse", ""), mimetype="text/xml")
        except RuntimeError as e:  # NonExistentQueue from the fake
            return Response(_xml(
                "ErrorResponse",
                f"<Error><Code>{_escape(str(e))}</Code></Error>"),
                status=400, mimetype="text/xml")
        return Response(_xml(
            "ErrorResponse",
            f"<Error><Code>InvalidAction</Code>"
            f"<Message>{_escape(action)}</Message></Error>"),
            status=400, mimetype="text/xml")

    # -- routes ----------------------------------------------------------------

    def _build(self) -> App:
        app = App("miniaws")

        @app.route("/", methods=["POST"])
        def sqs_root(request: Request):
            return self._sqs_dispatch(request, None)

        @app.route(f"/{self.ACCOUNT}/<name>", methods=["POST"])
        def sqs_queue(request: Request, name: str):
            return self._sqs_dispatch(request, name)

        @app.route("/<bucket>", methods=["PUT", "GET"])
        def bucket_ops(request: Request, bucket: str):
            if self.strict_auth and not self._header_auth_ok(request):
                return Response(b"", status=403)
            if request.method == "PUT":
                if "cors" in request.query:
                    self.cors[bucket] = request.body.decode("utf-8")
                    return Response(b"")
                if "notification" in request.query:
                    self._apply_notification_xml(
                        bucket, request.body.decode("utf-8"))
                    return Response(b"")
                self.s3.create_bucket(bucket)
                return Response(b"")
            if "notification" in request.query:
                return Response(
                    self.notification.get(
                        bucket, "<NotificationConfiguration/>"),
                    mimetype="application/xml")
            if "cors" in request.query:
                return Response(
                    self.cors.get(bucket, "<CORSConfiguration/>"),
                    mimetype="application/xml")
            return Response(b"", status=400)

        def _cors_headers(request: Request, bucket: str) -> Dict[str, str]:
            """Real S3 echoes CORS headers on the actual object response
            (not only the preflight) when the bucket CORS policy allows the
            Origin — browsers block the XHR result otherwise."""
            origin = request.environ.get("HTTP_ORIGIN")
            if not origin or bucket not in self.cors:
                return {}
            root = ET.fromstring(self.cors[bucket])
            origins = [e.text for e in root.iter()
                       if e.tag.endswith("AllowedOrigin")]
            if "*" not in origins and origin not in origins:
                return {}
            return {"Access-Control-Allow-Origin":
                    "*" if "*" in origins else origin}

        @app.route("/<bucket>/<path:key>", methods=["PUT"])
        def put_object(request: Request, bucket: str, key: str):
            if "X-Amz-Signature" in request.query or "X-Amz-Algorithm" in request.query:
                ok, reason = self._validate_presign(request, bucket, key)
                if not ok:
                    return Response(
                        f"<Error><Code>SignatureDoesNotMatch</Code>"
                        f"<Message>{_escape(reason)}</Message></Error>",
                        status=403, mimetype="application/xml")
            elif self.strict_auth and not self._header_auth_ok(request):
                return Response(b"", status=403)
            try:
                self.s3.put_object(bucket, key, request.body)
            except PermissionError as e:
                return Response(_escape(str(e)), status=403)
            return Response(b"", headers={"ETag": '"miniaws"',
                                          **_cors_headers(request, bucket)})

        @app.route("/<bucket>/<path:key>", methods=["GET"])
        def get_object(request: Request, bucket: str, key: str):
            if "X-Amz-Signature" in request.query:
                ok, reason = self._validate_presign(request, bucket, key)
                if not ok:
                    return Response(_escape(reason), status=403)
            elif self.strict_auth and not self._header_auth_ok(request):
                return Response(b"", status=403)
            try:
                path = self.s3._path(bucket, key)
            except PermissionError as e:
                return Response(_escape(str(e)), status=403)
            import os

            if not os.path.exists(path):
                return Response(
                    "<Error><Code>NoSuchKey</Code></Error>",
                    status=404, mimetype="application/xml")
            with open(path, "rb") as f:
                return Response(f.read(),
                                mimetype="application/octet-stream")

        @app.route("/<bucket>/<path:key>", methods=["OPTIONS"])
        def preflight(request: Request, bucket: str, key: str):
            """CORS preflight answered from the stored bucket CORS config —
            the contract the browser presigned-PUT flow depends on."""
            if bucket not in self.cors:
                return Response(b"", status=403)
            root = ET.fromstring(self.cors[bucket])
            origins = [e.text for e in root.iter() if e.tag.endswith("AllowedOrigin")]
            methods = [e.text for e in root.iter() if e.tag.endswith("AllowedMethod")]
            headers = [e.text for e in root.iter() if e.tag.endswith("AllowedHeader")]
            origin = request.environ.get("HTTP_ORIGIN", "*")
            if "*" not in origins and origin not in origins:
                return Response(b"", status=403)
            return Response(b"", headers={
                "Access-Control-Allow-Origin": origin if "*" not in origins else "*",
                "Access-Control-Allow-Methods": ", ".join(methods),
                "Access-Control-Allow-Headers": ", ".join(headers),
            })

        return app


def start_miniaws(root_dir: str, host: str = "127.0.0.1", port: int = 0,
                  **kw):
    """Serve a MiniAWS instance; returns (miniaws, server, base_url)."""
    from tvidz_tpu_torch.service.wsgi import start_server_thread

    aws = MiniAWS(root_dir, **kw)
    server, _ = start_server_thread(aws.app, host, port)
    base = f"http://{host}:{server.server_address[1]}"
    aws.set_base_url(base)
    return aws, server, base
