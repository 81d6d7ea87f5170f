"""PDF standard security handler (empty-password decryption).

Copy of `rag_application_tpu/ingest/pdf_crypt.py`.

The reference never parses encrypted PDFs itself — it hands every file
to pypdf/unoserver (IndexerAPI/src/core/processors/utils.py:24-66),
which transparently decrypt documents whose user password is empty
(the overwhelmingly common "permissions-only" encryption). This module
gives the native parser (ingest/pdf.py) the same capability:

  * RC4 40-128 bit, revisions 2 and 3 (V1/V2),
  * AES-128-CBC crypt filters, revision 4 (V4, /AESV2),
  * AES-256-CBC, revisions 5 and 6 (V5, /AESV3, ISO 32000-2),

all authenticated with the EMPTY user password (and, failing that, the
empty owner password). Documents that genuinely need a password raise
`PDFPasswordError`, which the ingest pipeline maps to a non-retryable
failure exactly like the old blanket "encrypted PDF unsupported" path.

AES rides the `cryptography` package when importable and otherwise a
pure-Python fallback (tables below), so the parser keeps working in a
stdlib-only environment — ingest streams are small enough that the
fallback's ~1 MB/s is acceptable.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict, Optional

__all__ = [
    "PDFCryptError",
    "PDFPasswordError",
    "StandardSecurityHandler",
    "rc4",
    "aes_cbc_encrypt",
    "aes_cbc_decrypt",
]


class PDFCryptError(ValueError):
    """Malformed or unsupported /Encrypt dictionary."""


class PDFPasswordError(PDFCryptError):
    """The document requires a non-empty password."""


# --------------------------------------------------------------------- RC4

def rc4(key: bytes, data: bytes) -> bytes:
    S = list(range(256))
    j = 0
    klen = len(key)
    for i in range(256):
        j = (j + S[i] + key[i % klen]) & 0xFF
        S[i], S[j] = S[j], S[i]
    out = bytearray(len(data))
    i = j = 0
    for n, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + S[i]) & 0xFF
        S[i], S[j] = S[j], S[i]
        out[n] = c ^ S[(S[i] + S[j]) & 0xFF]
    return bytes(out)


# --------------------------------------------------------------------- AES
# Fast path: the `cryptography` wheel (present in most images as a
# transitive dependency). Fallback: pure-Python AES — correct, slow,
# dependency-free.

try:  # pragma: no cover - exercised implicitly when available
    from cryptography.hazmat.primitives.ciphers import (  # type: ignore
        Cipher, algorithms, modes)

    def _aes_cbc(key: bytes, iv: bytes, data: bytes,
                 encrypt: bool) -> bytes:
        c = Cipher(algorithms.AES(key), modes.CBC(iv))
        ctx = c.encryptor() if encrypt else c.decryptor()
        return ctx.update(data) + ctx.finalize()

except Exception:  # pragma: no cover - stdlib-only environments
    _SBOX = bytearray(256)
    _INV_SBOX = bytearray(256)

    def _init_tables() -> None:
        p = q = 1
        _SBOX[0] = 0x63
        for _ in range(255):
            # p *= 3 in GF(2^8)
            p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
            # q /= 3
            q ^= (q << 1) & 0xFF
            q ^= (q << 2) & 0xFF
            q ^= (q << 4) & 0xFF
            if q & 0x80:
                q ^= 0x09
            x = q ^ ((q << 1) | (q >> 7)) & 0xFF ^ \
                ((q << 2) | (q >> 6)) & 0xFF ^ \
                ((q << 3) | (q >> 5)) & 0xFF ^ \
                ((q << 4) | (q >> 4)) & 0xFF
            _SBOX[p] = (x ^ 0x63) & 0xFF
        for i in range(256):
            _INV_SBOX[_SBOX[i]] = i

    _init_tables()

    def _xtime(a: int) -> int:
        a <<= 1
        return (a ^ 0x1B) & 0xFF if a & 0x100 else a

    _MUL = [[0] * 256 for _ in range(16)]
    for _c in (1, 2, 3, 9, 11, 13, 14):
        for _a in range(256):
            r, b, m = 0, _a, _c
            while m:
                if m & 1:
                    r ^= b
                b = _xtime(b)
                m >>= 1
            _MUL[_c][_a] = r

    def _expand_key(key: bytes) -> list:
        nk = len(key) // 4
        nr = nk + 6
        w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
        rcon = 1
        for i in range(nk, 4 * (nr + 1)):
            t = list(w[i - 1])
            if i % nk == 0:
                t = t[1:] + t[:1]
                t = [_SBOX[b] for b in t]
                t[0] ^= rcon
                rcon = _xtime(rcon)
            elif nk > 6 and i % nk == 4:
                t = [_SBOX[b] for b in t]
            w.append([w[i - nk][j] ^ t[j] for j in range(4)])
        return [sum(w[4 * r:4 * r + 4], []) for r in range(nr + 1)]

    def _add_rk(s: list, rk: list) -> None:
        for i in range(16):
            s[i] ^= rk[i]

    def _encrypt_block(s: list, rks: list) -> list:
        s = list(s)
        _add_rk(s, rks[0])
        nr = len(rks) - 1
        for rnd in range(1, nr):
            s = [_SBOX[b] for b in s]
            # shift rows (column-major state: s[r + 4c])
            s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
            ns = [0] * 16
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c:4 * c + 4]
                ns[4 * c + 0] = _MUL[2][a0] ^ _MUL[3][a1] ^ a2 ^ a3
                ns[4 * c + 1] = a0 ^ _MUL[2][a1] ^ _MUL[3][a2] ^ a3
                ns[4 * c + 2] = a0 ^ a1 ^ _MUL[2][a2] ^ _MUL[3][a3]
                ns[4 * c + 3] = _MUL[3][a0] ^ a1 ^ a2 ^ _MUL[2][a3]
            s = ns
            _add_rk(s, rks[rnd])
        s = [_SBOX[b] for b in s]
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        _add_rk(s, rks[nr])
        return s

    def _decrypt_block(s: list, rks: list) -> list:
        s = list(s)
        nr = len(rks) - 1
        _add_rk(s, rks[nr])
        for rnd in range(nr - 1, 0, -1):
            s = [s[(i - 4 * (i % 4)) % 16] for i in range(16)]
            s = [_INV_SBOX[b] for b in s]
            _add_rk(s, rks[rnd])
            ns = [0] * 16
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c:4 * c + 4]
                ns[4 * c + 0] = (_MUL[14][a0] ^ _MUL[11][a1] ^
                                 _MUL[13][a2] ^ _MUL[9][a3])
                ns[4 * c + 1] = (_MUL[9][a0] ^ _MUL[14][a1] ^
                                 _MUL[11][a2] ^ _MUL[13][a3])
                ns[4 * c + 2] = (_MUL[13][a0] ^ _MUL[9][a1] ^
                                 _MUL[14][a2] ^ _MUL[11][a3])
                ns[4 * c + 3] = (_MUL[11][a0] ^ _MUL[13][a1] ^
                                 _MUL[9][a2] ^ _MUL[14][a3])
            s = ns
        s = [s[(i - 4 * (i % 4)) % 16] for i in range(16)]
        s = [_INV_SBOX[b] for b in s]
        _add_rk(s, rks[0])
        return s

    def _aes_cbc(key: bytes, iv: bytes, data: bytes,
                 encrypt: bool) -> bytes:
        if len(data) % 16:
            raise PDFCryptError("AES data not block-aligned")
        rks = _expand_key(key)
        out = bytearray()
        prev = list(iv)
        if encrypt:
            for off in range(0, len(data), 16):
                blk = [data[off + i] ^ prev[i] for i in range(16)]
                prev = _encrypt_block(blk, rks)
                out.extend(prev)
        else:
            for off in range(0, len(data), 16):
                blk = list(data[off:off + 16])
                dec = _decrypt_block(blk, rks)
                out.extend(dec[i] ^ prev[i] for i in range(16))
                prev = blk
        return bytes(out)


def aes_cbc_encrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    return _aes_cbc(key, iv, data, True)


def aes_cbc_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    return _aes_cbc(key, iv, data, False)


# ------------------------------------------------------ standard handler

_PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41,
    0x64, 0x00, 0x4E, 0x56, 0xFF, 0xFA, 0x01, 0x08,
    0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
])


def _pad_password(pwd: bytes) -> bytes:
    return (pwd + _PAD)[:32]


def _as_bytes(v: Any) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("latin-1", "replace")
    return b""


def hash_r6(password: bytes, salt: bytes, udata: bytes = b"") -> bytes:
    """ISO 32000-2 Algorithm 2.B (revision 6 iterated hash)."""
    K = hashlib.sha256(password + salt + udata).digest()
    i = 0
    while True:
        K1 = (password + K + udata) * 64
        E = aes_cbc_encrypt(K[:16], K[16:32], K1)
        mod = sum(E[:16]) % 3
        K = (hashlib.sha256, hashlib.sha384,
             hashlib.sha512)[mod](E).digest()
        i += 1
        if i >= 64 and E[-1] <= i - 32:
            return K[:32]


def file_key_r2_r4(password: bytes, o: bytes, p: int, id0: bytes,
                   revision: int, key_len: int,
                   encrypt_metadata: bool) -> bytes:
    """Algorithm 2: the RC4/AES-128 file encryption key."""
    h = hashlib.md5()
    h.update(_pad_password(password))
    h.update(o[:32])
    h.update(struct.pack("<i", p))
    h.update(id0)
    if revision >= 4 and not encrypt_metadata:
        h.update(b"\xff\xff\xff\xff")
    key = h.digest()[:key_len]
    if revision >= 3:
        for _ in range(50):
            key = hashlib.md5(key[:key_len]).digest()[:key_len]
    return key


def user_check_bytes(key: bytes, id0: bytes, revision: int) -> bytes:
    """Algorithm 4/5: the /U entry derived from the file key."""
    if revision == 2:
        return rc4(key, _PAD)
    h = hashlib.md5(_PAD + id0).digest()
    u = rc4(key, h)
    for i in range(1, 20):
        u = rc4(bytes(b ^ i for b in key), u)
    return u  # 16 bytes; stored /U pads to 32 with arbitrary bytes


class StandardSecurityHandler:
    """Authenticates the empty password and decrypts strings/streams.

    `enc` is the resolved /Encrypt dictionary (values already resolved
    by the caller); `id0` is the first element of the trailer /ID.
    """

    def __init__(self, enc: Dict[str, Any], id0: bytes):
        filt = str(enc.get("Filter", "Standard"))
        if filt != "Standard":
            raise PDFCryptError(f"unsupported security handler {filt!r}")
        self.v = int(enc.get("V", 0) or 0)
        self.r = int(enc.get("R", 2) or 2)
        self.p = int(enc.get("P", -1) or -1)
        # /P is a signed 32-bit value but some writers store it unsigned
        if self.p > 0x7FFFFFFF:
            self.p -= 0x100000000
        self.encrypt_metadata = bool(enc.get("EncryptMetadata", True))
        self.o = _as_bytes(enc.get("O"))
        self.u = _as_bytes(enc.get("U"))
        self.id0 = id0
        # crypt-filter method for strings/streams ("rc4" | "aes" |
        # "identity"), V4+ configurable via /CF /StmF /StrF
        self.stm_method = "rc4"
        self.str_method = "rc4"
        if self.v in (1, 2):
            nbits = int(enc.get("Length", 40) or 40)
            self.key_len = max(5, min(16, nbits // 8))
            self._auth_r2_r4()
        elif self.v == 4:
            self.key_len = int(enc.get("Length", 128) or 128) // 8
            cf = enc.get("CF") or {}
            self.stm_method = self._cf_method(cf, enc.get("StmF"))
            self.str_method = self._cf_method(cf, enc.get("StrF"))
            if "aes" in (self.stm_method, self.str_method):
                self.key_len = 16
            self._auth_r2_r4()
        elif self.v == 5:
            cf = enc.get("CF") or {}
            self.stm_method = self._cf_method(cf, enc.get("StmF"), "aes")
            self.str_method = self._cf_method(cf, enc.get("StrF"), "aes")
            self.ue = _as_bytes(enc.get("UE"))
            self.oe = _as_bytes(enc.get("OE"))
            self._auth_r5_r6()
        else:
            raise PDFCryptError(f"unsupported encryption V={self.v}")

    @staticmethod
    def _cf_method(cf: Dict[str, Any], name: Any,
                   default: str = "identity") -> str:
        name = str(name or "Identity")
        if name == "Identity":
            return "identity"
        spec = cf.get(name)
        if not isinstance(spec, dict):
            return default
        cfm = str(spec.get("CFM", ""))
        if cfm == "V2":
            return "rc4"
        if cfm in ("AESV2", "AESV3"):
            return "aes"
        if cfm == "None":
            return "identity"
        return default

    # -- authentication ---------------------------------------------------

    def _auth_r2_r4(self) -> None:
        # empty USER password
        key = file_key_r2_r4(b"", self.o, self.p, self.id0, self.r,
                             self.key_len, self.encrypt_metadata)
        if self._u_matches(key):
            self.key = key
            return
        # empty OWNER password: Algorithm 3 backwards — derive the user
        # password from /O, then authenticate it
        h = hashlib.md5(_pad_password(b"")).digest()
        if self.r >= 3:
            for _ in range(50):
                h = hashlib.md5(h).digest()
        okey = h[:self.key_len]
        user_pwd = self.o
        if self.r == 2:
            user_pwd = rc4(okey, user_pwd)
        else:
            for i in range(19, -1, -1):
                user_pwd = rc4(bytes(b ^ i for b in okey), user_pwd)
        key = file_key_r2_r4(user_pwd[:32], self.o, self.p, self.id0,
                             self.r, self.key_len, self.encrypt_metadata)
        if self._u_matches(key):
            self.key = key
            return
        raise PDFPasswordError("PDF requires a password")

    def _u_matches(self, key: bytes) -> bool:
        want = user_check_bytes(key, self.id0, self.r)
        have = self.u
        if self.r == 2:
            return have[:32] == want[:32]
        return have[:16] == want[:16]

    def _auth_r5_r6(self) -> None:
        if len(self.u) < 48:
            raise PDFCryptError("short /U entry for V5 encryption")
        def sha(pwd: bytes, salt: bytes, udata: bytes) -> bytes:
            return hashlib.sha256(pwd + salt + udata).digest()

        for h in (hash_r6, sha):  # revision 6, then deprecated 5
            # empty USER password: salts live in /U, no udata
            if h(b"", self.u[32:40], b"") == self.u[:32]:
                ikey = h(b"", self.u[40:48], b"")
                self.key = aes_cbc_decrypt(ikey, b"\x00" * 16,
                                           self.ue[:32])
                return
            # empty OWNER password: salts in /O, udata = full 48-byte /U
            if len(self.o) >= 48 and \
                    h(b"", self.o[32:40], self.u[:48]) == self.o[:32]:
                ikey = h(b"", self.o[40:48], self.u[:48])
                self.key = aes_cbc_decrypt(ikey, b"\x00" * 16,
                                           self.oe[:32])
                return
        raise PDFPasswordError("PDF requires a password")

    # -- decryption --------------------------------------------------------

    def _object_key(self, num: int, gen: int, aes: bool) -> bytes:
        if self.v == 5:
            return self.key
        h = hashlib.md5()
        h.update(self.key)
        h.update(num.to_bytes(3, "little"))
        h.update(gen.to_bytes(2, "little"))
        if aes:
            h.update(b"sAlT")
        return h.digest()[:min(len(self.key) + 5, 16)]

    def _apply(self, data: bytes, num: int, gen: int,
               method: str) -> bytes:
        if method == "identity" or not data:
            return data
        if method == "rc4":
            return rc4(self._object_key(num, gen, False), data)
        # AES-CBC: first 16 bytes are the IV; strip PKCS#5 padding
        key = self._object_key(num, gen, True)
        if len(data) < 32 or (len(data) - 16) % 16:
            # some writers emit unpadded/empty AES payloads; be lenient
            if len(data) <= 16:
                return b""
            data = data[:16 + ((len(data) - 16) // 16) * 16]
        out = aes_cbc_decrypt(key, data[:16], data[16:])
        pad = out[-1] if out else 0
        if 1 <= pad <= 16:
            out = out[:-pad]
        return out

    def decrypt_stream(self, data: bytes, num: int, gen: int) -> bytes:
        return self._apply(data, num, gen, self.stm_method)

    def decrypt_string(self, data: bytes, num: int, gen: int) -> bytes:
        return self._apply(data, num, gen, self.str_method)

    # -- encryption (test-fixture construction; RC4 is symmetric) ----------

    def encrypt_stream(self, data: bytes, num: int, gen: int,
                       iv: bytes = b"\x00" * 16) -> bytes:
        if self.stm_method == "identity":
            return data
        if self.stm_method == "rc4":
            return rc4(self._object_key(num, gen, False), data)
        key = self._object_key(num, gen, True)
        pad = 16 - len(data) % 16
        return iv + aes_cbc_encrypt(key, iv, data + bytes([pad]) * pad)

    def encrypt_string(self, data: bytes, num: int, gen: int,
                       iv: bytes = b"\x00" * 16) -> bytes:
        if self.str_method == "identity":
            return data
        if self.str_method == "rc4":
            return rc4(self._object_key(num, gen, False), data)
        key = self._object_key(num, gen, True)
        pad = 16 - len(data) % 16
        return iv + aes_cbc_encrypt(key, iv, data + bytes([pad]) * pad)
