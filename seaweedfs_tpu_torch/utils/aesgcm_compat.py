"""AES-256-GCM via ctypes on the system libcrypto (OpenSSL EVP API).

Drop-in for `cryptography.hazmat.primitives.ciphers.aead.AESGCM` in the
one shape utils/cipher.py uses (no AAD). The container ships OpenSSL but
not the `cryptography` wheel; linking libcrypto directly keeps chunk
encryption working without a pip install, same approach as
native/rs_native.py takes for the GF kernels.

The port's copy of seaweedfs_tpu/utils/aesgcm_compat.py, the same code;
it imports nothing of that package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11
_TAG_LEN = 16

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        name = ctypes.util.find_library("crypto")
        candidates = [name] if name else []
        candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
        for cand in candidates:
            try:
                lib = ctypes.CDLL(cand)
                lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
                lib.EVP_aes_256_gcm.restype = ctypes.c_void_p
                lib.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
                for fn in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
                    getattr(lib, fn).argtypes = [
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_char_p, ctypes.c_char_p]
                for fn in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
                    getattr(lib, fn).argtypes = [
                        ctypes.c_void_p, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                        ctypes.c_int]
                for fn in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
                    getattr(lib, fn).argtypes = [
                        ctypes.c_void_p, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_int)]
                lib.EVP_CIPHER_CTX_ctrl.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                _lib = lib
                return _lib
            except (OSError, AttributeError):
                continue
        return None


def available() -> bool:
    return _load() is not None


class InvalidTag(Exception):
    pass


class AESGCM:
    """API-compatible subset of cryptography's AESGCM (no AAD support —
    utils/cipher.py always passes None)."""

    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError("AESGCM key must be 128/192/256 bits")
        if len(key) != 32:
            raise ValueError("libcrypto fallback supports 256-bit keys only")
        lib = _load()
        if lib is None:
            raise RuntimeError("libcrypto unavailable for AES-GCM")
        self._key = key
        self._lib = lib

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        assert aad is None, "AAD unsupported in libcrypto fallback"
        lib = self._lib
        ctx = lib.EVP_CIPHER_CTX_new()
        try:
            if not lib.EVP_EncryptInit_ex(ctx, lib.EVP_aes_256_gcm(),
                                          None, None, None):
                raise RuntimeError("EVP_EncryptInit_ex(cipher) failed")
            lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                    len(nonce), None)
            if not lib.EVP_EncryptInit_ex(ctx, None, None, self._key, nonce):
                raise RuntimeError("EVP_EncryptInit_ex(key/iv) failed")
            out = ctypes.create_string_buffer(len(data) or 1)
            outl = ctypes.c_int(0)
            if data and not lib.EVP_EncryptUpdate(ctx, out, ctypes.byref(outl),
                                                  data, len(data)):
                raise RuntimeError("EVP_EncryptUpdate failed")
            fin = ctypes.create_string_buffer(16)
            finl = ctypes.c_int(0)
            if not lib.EVP_EncryptFinal_ex(ctx, fin, ctypes.byref(finl)):
                raise RuntimeError("EVP_EncryptFinal_ex failed")
            tag = ctypes.create_string_buffer(_TAG_LEN)
            lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG, _TAG_LEN, tag)
            return (out.raw[:outl.value] + fin.raw[:finl.value]
                    + tag.raw[:_TAG_LEN])
        finally:
            lib.EVP_CIPHER_CTX_free(ctx)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        assert aad is None, "AAD unsupported in libcrypto fallback"
        if len(data) < _TAG_LEN:
            raise InvalidTag("ciphertext shorter than GCM tag")
        ct, tag = data[:-_TAG_LEN], data[-_TAG_LEN:]
        lib = self._lib
        ctx = lib.EVP_CIPHER_CTX_new()
        try:
            if not lib.EVP_DecryptInit_ex(ctx, lib.EVP_aes_256_gcm(),
                                          None, None, None):
                raise RuntimeError("EVP_DecryptInit_ex(cipher) failed")
            lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                    len(nonce), None)
            if not lib.EVP_DecryptInit_ex(ctx, None, None, self._key, nonce):
                raise RuntimeError("EVP_DecryptInit_ex(key/iv) failed")
            out = ctypes.create_string_buffer(len(ct) or 1)
            outl = ctypes.c_int(0)
            if ct and not lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl),
                                                ct, len(ct)):
                raise RuntimeError("EVP_DecryptUpdate failed")
            tagbuf = ctypes.create_string_buffer(tag, _TAG_LEN)
            lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_TAG, _TAG_LEN,
                                    tagbuf)
            fin = ctypes.create_string_buffer(16)
            finl = ctypes.c_int(0)
            if not lib.EVP_DecryptFinal_ex(ctx, fin, ctypes.byref(finl)):
                raise InvalidTag("GCM tag verification failed")
            return out.raw[:outl.value] + fin.raw[:finl.value]
        finally:
            lib.EVP_CIPHER_CTX_free(ctx)
