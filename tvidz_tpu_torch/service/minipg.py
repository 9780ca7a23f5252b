"""MiniPG — a PostgreSQL wire-protocol (v3) server emulator over sqlite.

The Postgres analog of MiniAWS (service/miniaws.py): this image has no
Postgres server, no docker, and no psycopg2, so the store's PG branch
could previously only be exercised by an import-level fake driver. MiniPG
moves that proof to the WIRE: the real first-party client
(corpus/pgwire.py) speaks startup + authentication (trust, cleartext,
MD5) + the extended query protocol over a real TCP socket, and MiniPG
executes the statements on sqlite through the same SQL translation the
fake-driver shim pioneered. What this proves in-image: the driver's
protocol framing, parameter/result codecs, auth exchanges, and every
Store SQL statement end-to-end over sockets. What still needs the real
server: Postgres's own SQL semantics — covered by CI's postgres:15
service container running the same store suite through this same driver
(unit-tests.yml).

Protocol notes (server side):
- Describe(portal) must answer RowDescription BEFORE Execute, so MiniPG
  runs the statement at Bind time and streams cached rows at Execute.
- Parameters arrive with the explicit type OIDs the client declared in
  Parse; they are decoded to Python values and adapted to sqlite exactly
  like the shim (arrays -> JSON text, timestamps -> ISO text).
- One shared sqlite database per server; statements serialize on a lock
  (the Store holds one connection per process).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import re
import secrets
import socket
import socketserver
import sqlite3
import struct
import threading
from typing import List, Optional, Tuple

from tvidz_tpu_torch.corpus import pgwire
from tvidz_tpu_torch.corpus.pgwire import (
    OID_BOOL,
    OID_BYTEA,
    OID_FLOAT8,
    OID_INT8,
    OID_TEXT,
    OID_TIMESTAMP,
    _ARRAY_ELEM,
    _FLOAT_OIDS,
    _INT_OIDS,
    _cstr,
    _msg,
    md5_password,
)


def translate_sql(sql: str) -> str:
    """PG dialect -> sqlite (the shim's translation, shared at one spot)."""
    sql = sql.replace("SERIAL PRIMARY KEY", "INTEGER PRIMARY KEY AUTOINCREMENT")
    sql = re.sub(r"DOUBLE PRECISION\[\]", "TEXT", sql)
    sql = re.sub(r"INTEGER\[\] DEFAULT '{}'", "TEXT DEFAULT '[]'", sql)
    sql = sql.replace("BYTEA", "BLOB")
    sql = sql.replace("TIMESTAMP", "TEXT")
    sql = sql.replace("VARCHAR", "TEXT")
    # $n placeholders -> positional ?
    sql = re.sub(r"\$\d+", "?", sql)
    return sql


def _decode_param(oid: int, raw: Optional[bytes]):
    if raw is None:
        return None
    text = raw.decode()
    if oid in _INT_OIDS:
        return int(text)
    if oid in _FLOAT_OIDS:
        return float(text)
    if oid == OID_BOOL:
        return text == "t"
    if oid == OID_BYTEA:
        return bytes.fromhex(text[2:])
    if oid == OID_TIMESTAMP:
        return text  # stored as ISO text, like the sqlite backend
    if oid in _ARRAY_ELEM or (oid == 0 and text.startswith("{")):
        elem = _ARRAY_ELEM.get(oid, float)
        return pgwire._parse_array(text, elem)
    return text


def _adapt_sqlite(value):
    if isinstance(value, list):
        return json.dumps(value)
    if isinstance(value, datetime.datetime):
        return value.isoformat()
    return value


def _infer_oid(rows: List[tuple], col: int) -> int:
    for row in rows:
        v = row[col]
        if v is None:
            continue
        if isinstance(v, bool):
            return OID_BOOL
        if isinstance(v, int):
            return OID_INT8
        if isinstance(v, float):
            return OID_FLOAT8
        if isinstance(v, (bytes, memoryview)):
            return OID_BYTEA
        return OID_TEXT
    return OID_TEXT


def _encode_cell(v) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, (bytes, memoryview)):
        return b"\\x" + bytes(v).hex().encode()
    if isinstance(v, float):
        return repr(v).encode()
    return str(v).encode()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # noqa: C901 — protocol state machine
        server: MiniPGServer = self.server  # type: ignore[assignment]
        sock = self.request
        buf = pgwire._Buf(sock)

        # Startup (possibly preceded by SSL/GSS negotiation requests).
        while True:
            (length,) = struct.unpack("!i", buf.read_exact(4))
            body = buf.read_exact(length - 4)
            (code,) = struct.unpack("!i", body[:4])
            if code in (80877103, 80877104):   # SSLRequest / GSSENCRequest
                sock.sendall(b"N")
                continue
            if code != 196608:
                sock.sendall(_error(b"FATAL", "unsupported protocol"))
                return
            params = body[4:].split(b"\x00")
            kv = dict(zip(params[0::2], params[1::2]))
            user = kv.get(b"user", b"").decode()
            break

        if not self._authenticate(sock, buf, server, user):
            return

        sock.sendall(
            _msg(b"R", struct.pack("!i", 0))
            + _msg(b"S", _cstr("server_version") + _cstr("15.0 (MiniPG)"))
            + _msg(b"K", struct.pack("!ii", 1, 1))
            + _msg(b"Z", b"I"))

        stmt_sql = ""
        stmt_oids: List[int] = []
        portal: Tuple[List[tuple], Optional[List[Tuple[str, int]]], int] = (
            [], None, -1)
        failed: Optional[str] = None

        while True:
            try:
                tag, payload = buf.read_message()
            except pgwire.PgError:
                return
            if tag == b"X":
                return
            if tag == b"Q":
                sql = payload.rstrip(b"\x00").decode()
                try:
                    rows, desc, count, tagname = server.execute(sql, [])
                    out = b""
                    if desc:
                        out += _row_description(desc)
                        out += b"".join(_data_row(r) for r in rows)
                    out += _msg(b"C", _cstr(tagname))
                    sock.sendall(out + _msg(b"Z", b"T"))
                except Exception as e:  # noqa: BLE001 — surface as pg error
                    sock.sendall(_error(b"ERROR", str(e)) + _msg(b"Z", b"E"))
                continue
            if tag == b"P":
                end = payload.index(b"\x00")                  # stmt name ""
                rest = payload[end + 1 :]
                qend = rest.index(b"\x00")
                stmt_sql = rest[:qend].decode()
                rest = rest[qend + 1 :]
                (n,) = struct.unpack("!h", rest[:2])
                stmt_oids = [
                    struct.unpack("!i", rest[2 + 4 * i : 6 + 4 * i])[0]
                    for i in range(n)
                ]
                sock.sendall(_msg(b"1", b""))
                continue
            if tag == b"B":
                off = payload.index(b"\x00") + 1              # portal ""
                off = payload.index(b"\x00", off) + 1         # stmt ""
                (nfmt,) = struct.unpack("!h", payload[off : off + 2])
                off += 2 + 2 * nfmt
                (nparams,) = struct.unpack("!h", payload[off : off + 2])
                off += 2
                raw_params: List[Optional[bytes]] = []
                for _ in range(nparams):
                    (ln,) = struct.unpack("!i", payload[off : off + 4])
                    off += 4
                    if ln == -1:
                        raw_params.append(None)
                    else:
                        raw_params.append(payload[off : off + ln])
                        off += ln
                try:
                    params = [
                        _decode_param(
                            stmt_oids[i] if i < len(stmt_oids) else 0, rp)
                        for i, rp in enumerate(raw_params)
                    ]
                    rows, desc, count, tagname = server.execute(
                        stmt_sql, params)
                    portal = (rows, desc, count)
                    self._tagname = tagname
                    failed = None
                except Exception as e:  # noqa: BLE001
                    failed = str(e)
                sock.sendall(_msg(b"2", b""))
                continue
            if tag == b"D":
                if failed is None and portal[1]:
                    sock.sendall(_row_description(portal[1]))
                else:
                    sock.sendall(_msg(b"n", b""))
                continue
            if tag == b"E":
                if failed is not None:
                    sock.sendall(_error(b"ERROR", failed))
                else:
                    rows, _desc, _count = portal
                    out = b"".join(_data_row(r) for r in rows)
                    out += _msg(b"C", _cstr(self._tagname))
                    sock.sendall(out)
                continue
            if tag == b"S":
                sock.sendall(_msg(b"Z", b"E" if failed is not None else b"T"))
                failed = None
                continue
            # Unknown message: ignore (Close, Flush, ...).

    def _authenticate(self, sock, buf, server, user: str) -> bool:
        mode = server.auth_mode
        password = server.users.get(user)
        if mode == "trust":
            return True
        if password is None:
            sock.sendall(_error(b"FATAL", f"no such user {user!r}"))
            return False
        if mode == "password":
            sock.sendall(_msg(b"R", struct.pack("!i", 3)))
            tag, payload = buf.read_message()
            ok = (tag == b"p"
                  and payload.rstrip(b"\x00").decode() == password)
        elif mode == "md5":
            salt = secrets.token_bytes(4)
            sock.sendall(_msg(b"R", struct.pack("!i", 5) + salt))
            tag, payload = buf.read_message()
            ok = (tag == b"p"
                  and payload.rstrip(b"\x00").decode()
                  == md5_password(user, password, salt))
        elif mode == "scram":
            ok = _scram_server_exchange(sock, buf, password)
        else:
            raise ValueError(f"unknown auth mode {mode}")
        if not ok:
            sock.sendall(_error(
                b"FATAL", f'password authentication failed for user "{user}"'))
        return ok


def _scram_server_exchange(sock, buf, password: str) -> bool:
    """Server side of SCRAM-SHA-256 (what a default postgres:15 runs) —
    exercises the client's full SASL state machine (codes 10/11/12),
    including its ServerSignature verification."""
    import hmac as _hmac

    sock.sendall(_msg(b"R", struct.pack("!i", 10)
                      + _cstr("SCRAM-SHA-256") + b"\x00"))
    tag, payload = buf.read_message()
    if tag != b"p":
        return False
    mech_end = payload.index(b"\x00")
    (ln,) = struct.unpack("!i", payload[mech_end + 1 : mech_end + 5])
    initial = payload[mech_end + 5 : mech_end + 5 + ln].decode()
    gs2, bare = initial[:3], initial[3:]
    fields = dict(f.split("=", 1) for f in bare.split(","))
    client_nonce = fields["r"]

    salt = secrets.token_bytes(16)
    iters = 4096
    server_nonce = client_nonce + base64.b64encode(
        secrets.token_bytes(12)).decode()
    server_first = (f"r={server_nonce},"
                    f"s={base64.b64encode(salt).decode()},i={iters}")
    sock.sendall(_msg(b"R", struct.pack("!i", 11) + server_first.encode()))

    tag, payload = buf.read_message()
    if tag != b"p":
        return False
    final = payload.decode()
    ffields = dict(f.split("=", 1) for f in final.split(","))
    proof = base64.b64decode(ffields["p"])
    without_proof = final[: final.rindex(",p=")]

    salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
    client_key = _hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored_key = hashlib.sha256(client_key).digest()
    auth_message = ",".join([bare, server_first, without_proof]).encode()
    client_sig = _hmac.new(stored_key, auth_message, hashlib.sha256).digest()
    recovered_key = bytes(a ^ b for a, b in zip(proof, client_sig))
    if (hashlib.sha256(recovered_key).digest() != stored_key
            or ffields["r"] != server_nonce
            or base64.b64decode(ffields["c"]).decode() != gs2):
        return False
    server_key = _hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    server_sig = _hmac.new(server_key, auth_message, hashlib.sha256).digest()
    sock.sendall(_msg(b"R", struct.pack("!i", 12)
                      + b"v=" + base64.b64encode(server_sig)))
    return True


def _row_description(desc: List[Tuple[str, int]]) -> bytes:
    body = struct.pack("!h", len(desc))
    for name, oid in desc:
        body += _cstr(name) + struct.pack("!ihihih", 0, 0, oid, -1, -1, 0)
    return _msg(b"T", body)


def _data_row(row: tuple) -> bytes:
    body = struct.pack("!h", len(row))
    for v in row:
        cell = _encode_cell(v)
        if cell is None:
            body += struct.pack("!i", -1)
        else:
            body += struct.pack("!i", len(cell)) + cell
    return _msg(b"D", body)


def _error(severity: bytes, message: str) -> bytes:
    return _msg(
        b"E",
        b"S" + severity + b"\x00" + b"C42601\x00"
        + b"M" + message.encode() + b"\x00" + b"\x00")


class MiniPGServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def process_request(self, request, client_address):
        # Mirror the client-side NODELAY (pgwire.Connection): response
        # frames are small and latency-bound.
        request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._socks_lock:
            self._client_socks.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._socks_lock:
            self._client_socks.discard(request)
        super().shutdown_request(request)

    def shutdown(self):
        """Stop accepting AND drop established connections — a real server
        stop closes client sockets; handler threads blocked in recv would
        otherwise keep serving the old sockets forever (daemon threads).
        Also releases the listening socket so the port can be rebound."""
        super().shutdown()
        self.server_close()
        with self._socks_lock:
            socks, self._client_socks = list(self._client_socks), set()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        # Release the shared sqlite handle: a handler severed between BEGIN
        # and COMMIT would otherwise leave a RESERVED write lock on a
        # file-backed db until this object is GC'd, so a restarted server
        # on the same path gets 'database is locked' — the failure the
        # failover leg exists to rule out. Taking _lock first lets any
        # in-flight statement finish.
        with self._lock:
            try:
                self._db.rollback()
            except sqlite3.Error:
                pass
            try:
                self._db.close()
            except sqlite3.Error:
                pass

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth_mode: str = "trust",
                 users: Optional[dict] = None,
                 db_path: Optional[str] = None):
        super().__init__((host, port), _Handler)
        self.auth_mode = auth_mode
        self.users = users or {}
        # db_path makes the server durable across restarts (the real-PG
        # failover shape: server goes away, data doesn't) — used by the
        # integration failover leg; default stays in-memory.
        self.db_path = db_path
        self._db = sqlite3.connect(db_path or ":memory:",
                                   check_same_thread=False)
        self._db.isolation_level = None     # explicit BEGIN/COMMIT only
        self._lock = threading.Lock()
        self._client_socks: set = set()
        self._socks_lock = threading.Lock()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def execute(self, sql: str, params: List
                ) -> Tuple[List[tuple], Optional[List[Tuple[str, int]]], int, str]:
        """Run one (possibly multi-)statement; returns (rows, description,
        rowcount, command tag)."""
        with self._lock:
            cur = self._db.cursor()
            translated = translate_sql(sql)
            adapted = [_adapt_sqlite(p) for p in params]
            stripped = translated.strip().rstrip(";")
            first = (stripped.split(None, 1) or [""])[0].upper()
            if not params and ";" in stripped:
                cur.executescript(translated)
                return [], None, -1, "MULTI"
            if first in ("BEGIN", "COMMIT", "ROLLBACK"):
                try:
                    cur.execute(stripped)
                except sqlite3.OperationalError:
                    pass  # idempotent txn control (e.g. COMMIT w/o BEGIN)
                return [], None, -1, first
            cur.execute(translated, adapted)
            rows = cur.fetchall()
            desc = None
            if cur.description is not None:
                desc = [
                    (cur.description[i][0], _infer_oid(rows, i))
                    for i in range(len(cur.description))
                ]
            count = cur.rowcount if cur.rowcount is not None else -1
            if first == "SELECT":
                tagname = f"SELECT {len(rows)}"
            elif first == "INSERT":
                tagname = f"INSERT 0 {max(count, 0)}"
            else:
                tagname = f"{first} {max(count, 0)}"
            return rows, desc, count, tagname


def start_minipg(auth_mode: str = "trust", users: Optional[dict] = None,
                 db_path: Optional[str] = None, port: int = 0
                 ) -> MiniPGServer:
    """Start a MiniPG server (ephemeral port by default; pass an explicit
    ``port`` to rebind a restarted server on the address clients already
    hold, and ``db_path`` for durable storage across restarts). Returns the
    server (shut down with .shutdown(); .port has the bound port)."""
    server = MiniPGServer(port=port, auth_mode=auth_mode, users=users,
                          db_path=db_path)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
