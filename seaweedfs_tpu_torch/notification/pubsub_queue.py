"""Google-Pub/Sub-wire notification queue (reference weed/notification/
google_pub_sub/google_pub_sub.go, which uses the GCP SDK; here the
Pub/Sub REST publish API is spoken directly — JSON POST with a Bearer
token, no SDK).

Auth is a static bearer token from configuration (a service-account
OAuth flow needs egress this environment doesn't have; any
Pub/Sub-compatible emulator accepts tokenless/static-token calls).
Tests run against MiniPubSubServer below.

The port's copy of seaweedfs_tpu/notification/pubsub_queue.py. It imports
nothing of that package.
"""

from __future__ import annotations

import base64
import json

from seaweedfs_tpu_torch.notification.queue import MessageQueue
from seaweedfs_tpu_torch.utils.httpd import http_call


class PubSubQueue(MessageQueue):
    name = "google_pub_sub"

    def __init__(self, endpoint: str, project: str, topic: str,
                 token: str = "", timeout: float = 10.0):
        self.endpoint = endpoint.rstrip("/")
        self.project = project
        self.topic = topic
        self.token = token
        self.timeout = timeout

    def send_message(self, key: str, message: dict) -> None:
        url = (f"{self.endpoint}/v1/projects/{self.project}"
               f"/topics/{self.topic}:publish")
        payload = json.dumps({"messages": [{
            "data": base64.b64encode(
                json.dumps(message).encode()).decode(),
            "attributes": {"key": key},
        }]}).encode()
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        # http_call (not raw urllib) so the ambient Deadline/QoS-class/
        # Trace of the write that triggered this notification propagate
        # into the broker hop
        status, _, _ = http_call("POST", url, body=payload,
                                 timeout=self.timeout, headers=headers)
        if status >= 300:
            raise ConnectionError(f"Pub/Sub publish: {status}")


class MiniPubSubServer:
    """In-process Pub/Sub publish endpoint for tests: checks the Bearer
    token and records decoded messages per topic."""

    def __init__(self, token: str = ""):
        from seaweedfs_tpu_torch.utils.httpd import HttpServer, Response
        self.token = token
        self.messages: list[dict] = []
        self._response_cls = Response
        self.http = HttpServer("127.0.0.1", 0)
        self.http.add("POST",
                      r"/v1/projects/([^/]+)/topics/([^:]+):publish$",
                      self._publish)

    def start(self):
        self.http.start()
        return self

    def stop(self):
        self.http.stop()

    @property
    def url(self) -> str:
        return f"http://{self.http.host}:{self.http.port}"

    def _publish(self, req) -> "Response":
        Response = self._response_cls
        if self.token:
            if req.headers.get("Authorization") != f"Bearer {self.token}":
                return Response({"error": {"code": 401}}, status=401)
        body = req.json()
        ids = []
        for m in body.get("messages", []):
            self.messages.append({
                "project": req.match.group(1),
                "topic": req.match.group(2),
                "key": m.get("attributes", {}).get("key", ""),
                "message": json.loads(base64.b64decode(m["data"])),
            })
            ids.append(str(len(self.messages)))
        return Response({"messageIds": ids})
