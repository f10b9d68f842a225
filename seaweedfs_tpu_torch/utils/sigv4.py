"""AWS Signature Version 4 canonicalization — THE single copy.

Both halves of the protocol import this: the S3 gateway verifies with it
(gateway/s3_server.py, reference weed/s3api/auth_signature_v4.go) and the
S3 remote-storage client signs with it (remote_storage/s3_client.py).
One implementation means the two can never drift apart on
canonicalization details (quote alphabet, header folding, scope order).

The port's copy of seaweedfs_tpu/utils/sigv4.py, the same code with its
imports pointed at the port; it imports nothing of that package.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse


def signing_key(secret: str, date: str, region: str,
                service: str) -> bytes:
    k = ("AWS4" + secret).encode()
    for msg in (date, region, service, "aws4_request"):
        k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
    return k


def signature(secret: str, date: str, region: str, service: str,
              amz_date: str, method: str, path: str, query: dict,
              headers, signed_headers: list[str],
              payload_hash: str) -> str:
    """Hex SigV4 over a canonical request. `path` is the WIRE path,
    still percent-encoded exactly as the signer sent it (re-quoting
    would double-encode); `headers` is any mapping with .get()."""
    cq = "&".join(
        f"{urllib.parse.quote(k, safe='~')}="
        f"{urllib.parse.quote(str(v), safe='~')}"
        for k, v in sorted(query.items()))
    ch = "".join(f"{h}:{headers.get(h, '').strip()}\n"
                 for h in signed_headers)
    creq = "\n".join([method, path, cq, ch, ";".join(signed_headers),
                      payload_hash])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = signing_key(secret, date, region, service)
    return hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
