"""Security: JWT (HS256) write authorization + IP guard.

Functional equivalent of reference weed/security/jwt.go + guard.go: the
master mints a short-lived token scoped to a fid when a signing key is
configured; volume servers require it on writes/deletes. Stdlib-only
HS256 implementation.

The port's copy of seaweedfs_tpu/utils/security.py, the same code; it imports
nothing of that package.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import ipaddress
import json
import time
from typing import Optional


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def gen_jwt(signing_key: str, fid: str, expires_seconds: int = 10) -> str:
    """Mint a token for one file id (reference GenJwtForVolumeServer)."""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps({
        "exp": int(time.time()) + expires_seconds,
        "fid": fid,
    }).encode())
    msg = f"{header}.{payload}".encode()
    sig = _b64(hmac.new(signing_key.encode(), msg, hashlib.sha256).digest())
    return f"{header}.{payload}.{sig}"


def verify_jwt(signing_key: str, token: str,
               fid: Optional[str] = None) -> bool:
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        return False
    msg = f"{header}.{payload}".encode()
    want = _b64(hmac.new(signing_key.encode(), msg, hashlib.sha256).digest())
    if not hmac.compare_digest(want, sig):
        return False
    try:
        claims = json.loads(_unb64(payload))
    except (ValueError, json.JSONDecodeError):
        return False
    if claims.get("exp", 0) < time.time():
        return False
    if fid is not None and claims.get("fid") not in (fid, fid.split("_")[0]):
        return False
    return True


class Guard:
    """IP whitelist (reference security/guard.go:17-50). Empty list allows
    everyone."""

    def __init__(self, whitelist: Optional[list[str]] = None):
        self.networks = []
        for item in whitelist or []:
            if "/" in item:
                self.networks.append(ipaddress.ip_network(item, strict=False))
            else:
                self.networks.append(
                    ipaddress.ip_network(item + "/32", strict=False))

    def allowed(self, ip: str) -> bool:
        if not self.networks:
            return True
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)
