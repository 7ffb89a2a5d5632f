"""HTTP serving of a live ServingModel.

The endpoints and their JSON contract are the JAX package's
(``triad_tpu/serve/server.py``): GET /healthz, POST /v1/embed/audio,
/v1/embed/image, /v1/embed/text and /v1/score. Its handler class is
reused as it is, bound to a ServingModel instead of an export bundle.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer

from triad_tpu.serve.server import _Handler
from triad_tpu_torch.serve.model import ServingModel


def make_server(serving_model: ServingModel, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; .serve_forever() to run."""
    handler = type(
        "TorchHandler", (_Handler,),
        {"bundle": serving_model, "lock": threading.Lock()},
    )
    return ThreadingHTTPServer((host, port), handler)
