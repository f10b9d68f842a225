"""Chunk encryption: AES-256-GCM with a random per-chunk key.

Functional equivalent of reference weed/util/cipher.go (Encrypt/Decrypt):
each encrypted chunk gets its own random 256-bit key, stored in the
chunk's metadata (FileChunk.cipher_key) in the filer — volume servers
only ever see ciphertext. The 12-byte nonce is prepended to the
ciphertext, as in the reference.

The port's copy of seaweedfs_tpu/utils/cipher.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import os

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ModuleNotFoundError:  # container has OpenSSL but not the wheel
    from seaweedfs_tpu_torch.utils.aesgcm_compat import AESGCM

KEY_SIZE = 32
NONCE_SIZE = 12


def encrypt(data: bytes) -> tuple[bytes, bytes]:
    """Returns (nonce + ciphertext+tag, key)."""
    key = os.urandom(KEY_SIZE)
    nonce = os.urandom(NONCE_SIZE)
    sealed = AESGCM(key).encrypt(nonce, data, None)
    return nonce + sealed, key


def decrypt(blob: bytes, key: bytes) -> bytes:
    nonce, sealed = blob[:NONCE_SIZE], blob[NONCE_SIZE:]
    return AESGCM(key).decrypt(nonce, sealed, None)
