"""One HTTP/1.1 client on a keep-alive connection, sending multipart forms
as the reference's pages do, and timing each round trip from just before
its bytes are sent to the last byte of the reply."""

from __future__ import annotations

import http.client
import time
import uuid
from dataclasses import dataclass


@dataclass
class Reply:
    status: int
    body: bytes
    sent: float            # time.perf_counter() before the request's bytes
    received: float        # ... after the reply's last byte


def multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    """(body, content type) of a multipart/form-data form: ``fields`` maps
    names to text, ``files`` names to (file name, bytes)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (filename, content) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{name}"; filename="{filename}"\r\n'
                     f'Content-Type: application/octet-stream\r\n\r\n'
                     .encode() + content + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class Client:
    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.conn = http.client.HTTPConnection(host, port, timeout=timeout)

    def post(self, route: str, fields: dict, files: dict | None = None
             ) -> Reply:
        body, ctype = multipart(fields, files or {})
        headers = {"Content-Type": ctype, "Content-Length": str(len(body))}
        sent = time.perf_counter()
        self.conn.request("POST", route, body=body, headers=headers)
        resp = self.conn.getresponse()
        data = resp.read()
        return Reply(resp.status, data, sent, time.perf_counter())

    def close(self):
        self.conn.close()
