"""HTTP serving of an exported bundle or a live model (stdlib
``http.server``).

The routes and their JSON contract are those of
``triad_tpu/serve/server.py``; this is the port's own handler, bound to a
``ServingBundle`` (``serve/export.py``: the exported programs, no model
code) or a live ``ServingModel`` (``serve/model.py``), which have the
same methods. POST bodies and responses are JSON with arrays as nested
lists; the single-array endpoints also take and answer
``Content-Type: application/x-npy``.

  GET  /healthz               model metadata
  POST /v1/embed/audio        {"audio": [[...T floats]]}        -> {"tokens": ...}
  POST /v1/embed/image        {"images": [[[..HxWx3..]]]}       -> {"tokens": ...}
  POST /v1/embed/text         {"texts": ["a dog", ...]}         -> {"tokens": ..., "mask": ...}
                              or {"ids": [[...]], "mask": [[...]]}
  POST /v1/score              {"query": {"tokens":..,"mask":..},
                               "key":   {"tokens":..,"mask":..},
                               "direction": "av"|"tv"|"raw",
                               "temperature": optional float}   -> {"scores": [[...]]}

``direction`` applies the retrieval preparation: "av" L2-normalizes both
sides, "tv" passes raw features (the reference's asymmetry), "raw" does
nothing.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np


def _l2(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


class _Handler(BaseHTTPRequestHandler):
    bundle: object  # a ServingBundle or a ServingModel, set by make_server
    # One model call at a time: keeps device memory bounded.
    lock: threading.Lock

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def _send_json(self, obj, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_npy(self, arr: np.ndarray) -> None:
        buf = io.BytesIO()
        np.save(buf, arr)
        data = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _array_in(self, body: bytes, key: str) -> Tuple[np.ndarray, bool]:
        """(array, want_npy_response)"""
        if self.headers.get("Content-Type", "") == "application/x-npy":
            return np.load(io.BytesIO(body), allow_pickle=False), True
        return np.asarray(json.loads(body)[key], np.float32), False

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json({"status": "ok", **self.bundle.meta})
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self):
        try:
            body = self._read_body()
            with self.lock:
                if self.path == "/v1/embed/audio":
                    arr, npy = self._array_in(body, "audio")
                    out = self.bundle.embed_audio(arr)
                    if npy:
                        return self._send_npy(out)
                    return self._send_json({"tokens": out.tolist()})
                if self.path == "/v1/embed/image":
                    arr, npy = self._array_in(body, "images")
                    out = self.bundle.embed_visual(arr)
                    if npy:
                        return self._send_npy(out)
                    return self._send_json({"tokens": out.tolist()})
                if self.path == "/v1/embed/text":
                    req = json.loads(body)
                    if "texts" in req:
                        out = self.bundle.embed_texts(req["texts"])
                        return self._send_json({"tokens": out["tokens"].tolist(),
                                                "mask": out["mask"].tolist()})
                    ids = np.asarray(req["ids"], np.int32)
                    mask = np.asarray(req["mask"], np.float32)
                    out = self.bundle.embed_text_ids(ids, mask)
                    return self._send_json({"tokens": out.tolist()})
                if self.path == "/v1/score":
                    req = json.loads(body)
                    q = np.asarray(req["query"]["tokens"], np.float32)
                    qm = np.asarray(req["query"]["mask"], np.float32)
                    k = np.asarray(req["key"]["tokens"], np.float32)
                    km = np.asarray(req["key"]["mask"], np.float32)
                    direction = req.get("direction", "raw")
                    if direction == "av":
                        q, k = _l2(q), _l2(k)
                    elif direction not in ("tv", "raw"):
                        return self._send_json({"error": f"bad direction {direction!r}"}, 400)
                    scores = self.bundle.pair_scores(q, qm, k, km, req.get("temperature"))
                    return self._send_json({"scores": scores.tolist()})
            self._send_json({"error": "not found"}, 404)
        except Exception as e:  # noqa: BLE001 — surface as HTTP 400
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 400)


def make_server(serving, host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server over ``serving``, a ServingBundle
    or a ServingModel; .serve_forever() to run."""
    handler = type(
        "TorchHandler", (_Handler,),
        {"bundle": serving, "lock": threading.Lock()},
    )
    return ThreadingHTTPServer((host, port), handler)
