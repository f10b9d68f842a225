"""AWS-SQS-wire notification queue (reference weed/notification/aws_sqs/
aws_sqs_pub.go, which uses the AWS SDK; here the SQS HTTP query API is
spoken directly — SigV4-signed form POSTs, no SDK, same dependency-free
approach as the Kafka and S3 wire clients).

Works against real SQS-compatible endpoints (AWS, localstack,
elasticmq); tests run against MiniSqsServer below.

The port's copy of seaweedfs_tpu/notification/sqs_queue.py, signing
through the port's utils/sigv4.py. It imports nothing of that package.
"""

from __future__ import annotations

import hashlib
import json
import time
import urllib.parse

from seaweedfs_tpu_torch.notification.queue import MessageQueue
from seaweedfs_tpu_torch.utils import sigv4
from seaweedfs_tpu_torch.utils.httpd import http_call

API_VERSION = "2012-11-05"


class SqsQueue(MessageQueue):
    name = "aws_sqs"

    def __init__(self, queue_url: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout: float = 10.0):
        self.queue_url = queue_url.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout

    def send_message(self, key: str, message: dict) -> None:
        body = urllib.parse.urlencode({
            "Action": "SendMessage",
            "Version": API_VERSION,
            "MessageBody": json.dumps({"key": key, "message": message}),
            "MessageAttribute.1.Name": "key",
            "MessageAttribute.1.Value.DataType": "String",
            "MessageAttribute.1.Value.StringValue": key,
        }).encode()
        u = urllib.parse.urlparse(self.queue_url)
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        date = amz_date[:8]
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {
            "Host": u.netloc,
            "Content-Type": "application/x-www-form-urlencoded",
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }
        signed = ["content-type", "host", "x-amz-content-sha256",
                  "x-amz-date"]
        lower = {k.lower(): v for k, v in headers.items()}
        sig = sigv4.signature(self.secret_key, date, self.region, "sqs",
                              amz_date, "POST", u.path or "/", {},
                              lower, signed, payload_hash)
        scope = f"{date}/{self.region}/sqs/aws4_request"
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        # SigV4 signs only the headers in `signed`; the extra
        # X-Weed-* headers http_call injects ride unsigned, so the
        # signature stays valid while deadline/class/trace propagate
        status, _, _ = http_call("POST", self.queue_url, body=body,
                                 timeout=self.timeout, headers=headers)
        if status >= 300:
            raise ConnectionError(f"SQS SendMessage: {status}")


class MiniSqsServer:
    """In-process SQS endpoint for tests: verifies the SigV4 signature
    against the configured secret and records SendMessage bodies."""

    def __init__(self, access_key: str = "AK", secret_key: str = "SK",
                 region: str = "us-east-1"):
        from seaweedfs_tpu_torch.utils.httpd import HttpServer, Response
        self.access_key, self.secret_key = access_key, secret_key
        self.region = region
        self.messages: list[dict] = []
        self.http = HttpServer("127.0.0.1", 0)
        self._response_cls = Response
        self.http.add("POST", r"/queue/(.+)$", self._send)

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self) -> str:
        return f"http://{self.http.host}:{self.http.port}"

    def _send(self, req) -> "Response":
        Response = self._response_cls
        auth = req.headers.get("Authorization", "")
        if not self._verify(req, auth):
            return Response(b"<Error><Code>SignatureDoesNotMatch"
                            b"</Code></Error>", status=403,
                            content_type="application/xml")
        form = urllib.parse.parse_qs(req.body.decode())
        if form.get("Action") != ["SendMessage"]:
            return Response(b"<Error><Code>InvalidAction</Code></Error>",
                            status=400, content_type="application/xml")
        body = form["MessageBody"][0]
        self.messages.append({
            "queue": req.match.group(1),
            "body": json.loads(body),
            "key": form.get(
                "MessageAttribute.1.Value.StringValue", [""])[0],
        })
        md5 = hashlib.md5(body.encode()).hexdigest()
        return Response(
            (f"<SendMessageResponse><SendMessageResult>"
             f"<MD5OfMessageBody>{md5}</MD5OfMessageBody>"
             f"<MessageId>{len(self.messages)}</MessageId>"
             f"</SendMessageResult></SendMessageResponse>").encode(),
            content_type="application/xml")

    def _verify(self, req, auth: str) -> bool:
        try:
            cred = auth.split("Credential=")[1].split(",")[0]
            access_key, date, region, service, _ = cred.split("/")
            signed = auth.split("SignedHeaders=")[1].split(",")[0].split(";")
            their_sig = auth.split("Signature=")[1].strip()
        except (IndexError, ValueError):
            return False
        if access_key != self.access_key:
            return False
        headers = {k.lower(): v for k, v in req.headers.items()}
        ours = sigv4.signature(
            self.secret_key, date, region, service,
            headers.get("x-amz-date", ""), "POST", req.path, {},
            headers, signed, headers.get("x-amz-content-sha256", ""))
        return ours == their_sig
