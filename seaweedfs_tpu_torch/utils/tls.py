"""Mutual TLS for the control plane (reference weed/security/tls.go).

The reference secures every gRPC plane with mTLS when security.toml's
[grpc] section names a CA + per-role cert/key; this module is the same
contract for the three gRPC planes here (master/volume/filer) plus the
HTTP admin listener. Loading precedence mirrors the reference: the
per-role section ([grpc.master], [grpc.volume], ...) overrides [grpc].

Also ships a self-signed chain generator (CA + per-role leaf certs,
`cryptography` backed) used by tests and `weed-tpu scaffold -tls`.

The port's copy of seaweedfs_tpu/utils/tls.py, on the port's
utils/config.py. It imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
from typing import Optional

from seaweedfs_tpu_torch.utils import config as config_mod


@dataclasses.dataclass
class TlsConfig:
    ca_file: str
    cert_file: str
    key_file: str

    def read(self) -> tuple[bytes, bytes, bytes]:
        with open(self.ca_file, "rb") as f:
            ca = f.read()
        with open(self.cert_file, "rb") as f:
            cert = f.read()
        with open(self.key_file, "rb") as f:
            key = f.read()
        return ca, cert, key


def load_tls_config(role: str = "") -> Optional[TlsConfig]:
    """TlsConfig from security.toml ([grpc] / [grpc.<role>]), or None when
    mTLS is not configured (reference util.LoadSecurityConfiguration +
    security.LoadServerTLS)."""
    conf = config_mod.load_configuration("security")
    base = conf.get("grpc", {}) if conf else {}
    section = dict(base)
    if role and isinstance(base.get(role), dict):
        section.update(base[role])
    ca = section.get("ca", "")
    cert = section.get("cert", "")
    key = section.get("key", "")
    if not (ca and cert and key):
        return None
    return TlsConfig(ca_file=ca, cert_file=cert, key_file=key)


def make_channel(address: str, role: str = "client",
                 tls="auto"):
    """grpc channel honoring security.toml mTLS config ("auto"), an
    explicit TlsConfig, or None for insecure."""
    import grpc
    cfg = load_tls_config(role) if tls == "auto" else tls
    if cfg is not None:
        return grpc.secure_channel(address, channel_credentials(cfg))
    return grpc.insecure_channel(address)


def server_credentials(cfg: TlsConfig):
    """grpc server credentials REQUIRING a client cert signed by the CA
    (reference tls.go: ClientAuth: tls.RequireAndVerifyClientCert)."""
    import grpc
    ca, cert, key = cfg.read()
    return grpc.ssl_server_credentials(
        [(key, cert)], root_certificates=ca, require_client_auth=True)


def channel_credentials(cfg: TlsConfig):
    import grpc
    ca, cert, key = cfg.read()
    return grpc.ssl_channel_credentials(
        root_certificates=ca, private_key=key, certificate_chain=cert)


def wrap_http_server(http_server, cfg: TlsConfig) -> None:
    """Upgrade an HttpServer's listening socket to mTLS (client cert
    required) — the HTTP admin plane equivalent of the gRPC credentials."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.load_verify_locations(cfg.ca_file)
    ctx.verify_mode = ssl.CERT_REQUIRED
    http_server._httpd.socket = ctx.wrap_socket(
        http_server._httpd.socket, server_side=True)


def generate_self_signed(out_dir: str, roles: tuple[str, ...] = (
        "master", "volume", "filer", "client"),
        host: str = "127.0.0.1") -> dict[str, TlsConfig]:
    """Write ca.crt + <role>.crt/<role>.key under out_dir; returns a
    TlsConfig per role. Test/dev helper (the reference documents using
    openssl/easyrsa; same output shape). Uses `cryptography` when
    installed, else the openssl CLI."""
    try:
        from cryptography import x509  # noqa: F401
    except ModuleNotFoundError:
        return _generate_via_openssl_cli(out_dir, roles, host)
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(out_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    one_day = datetime.timedelta(days=1)

    ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "seaweedfs-tpu-test-ca")])
    ca_cert = (x509.CertificateBuilder()
               .subject_name(ca_name).issuer_name(ca_name)
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - one_day)
               .not_valid_after(now + 30 * one_day)
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=None),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    ca_path = os.path.join(out_dir, "ca.crt")
    with open(ca_path, "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))

    out: dict[str, TlsConfig] = {}
    san = x509.SubjectAlternativeName([
        x509.DNSName("localhost"),
        x509.IPAddress(ipaddress.ip_address(host))])
    for role in roles:
        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        cert = (x509.CertificateBuilder()
                .subject_name(x509.Name([x509.NameAttribute(
                    NameOID.COMMON_NAME, f"seaweedfs-tpu-{role}")]))
                .issuer_name(ca_name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - one_day)
                .not_valid_after(now + 30 * one_day)
                .add_extension(san, critical=False)
                .sign(ca_key, hashes.SHA256()))
        cert_path = os.path.join(out_dir, f"{role}.crt")
        key_path = os.path.join(out_dir, f"{role}.key")
        with open(cert_path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
        with open(key_path, "wb") as f:
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption()))
        out[role] = TlsConfig(ca_file=ca_path, cert_file=cert_path,
                              key_file=key_path)
    return out


def _generate_via_openssl_cli(out_dir: str, roles: tuple[str, ...],
                              host: str) -> dict[str, TlsConfig]:
    """Same chain via the openssl binary, for a host without
    `cryptography`."""
    import subprocess

    def run(*args: str) -> None:
        subprocess.run(["openssl", *args], check=True, capture_output=True)

    os.makedirs(out_dir, exist_ok=True)
    ca_path = os.path.join(out_dir, "ca.crt")
    ca_key = os.path.join(out_dir, "ca.key")
    # note: req -x509 already emits basicConstraints critical,CA:TRUE;
    # adding it again via -addext duplicates the extension and OpenSSL
    # then refuses to chain to the CA (verify error 20)
    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-sha256",
        "-keyout", ca_key, "-out", ca_path, "-days", "30",
        "-subj", "/CN=seaweedfs-tpu-test-ca")
    ext_path = os.path.join(out_dir, "san.cnf")
    with open(ext_path, "w") as f:
        f.write(f"subjectAltName=DNS:localhost,IP:{host}\n")
    out: dict[str, TlsConfig] = {}
    for role in roles:
        key_path = os.path.join(out_dir, f"{role}.key")
        cert_path = os.path.join(out_dir, f"{role}.crt")
        csr_path = os.path.join(out_dir, f"{role}.csr")
        run("req", "-newkey", "rsa:2048", "-nodes", "-sha256",
            "-keyout", key_path, "-out", csr_path,
            "-subj", f"/CN=seaweedfs-tpu-{role}")
        run("x509", "-req", "-in", csr_path, "-CA", ca_path,
            "-CAkey", ca_key, "-CAcreateserial", "-sha256",
            "-out", cert_path, "-days", "30", "-extfile", ext_path)
        os.remove(csr_path)
        out[role] = TlsConfig(ca_file=ca_path, cert_file=cert_path,
                              key_file=key_path)
    os.remove(ext_path)
    return out
