# coding=utf-8
"""HTTP serving daemon over `RetrievalEngine` (port of the JAX package's
`serve/http.py`; standard library only).

Endpoints
---------
GET  /healthz          -> {"ok": true, "videos": N, "dim": D,
                           "quantize": "...", "model": "...",
                           "sim_header": "..."}
POST /search           <- {"queries": ["...", ...], "k": 5}
                       -> {"results": [[{"video_id", "score"}, ...], ...],
                           "took_ms": float}

One engine, one card: requests run through one lock, so the card's work of
one request is never interleaved with another's; the threaded server still
overlaps socket IO and JSON parsing of waiting clients with the current
request.  The engine enters `torch.inference_mode()` per call, in the
handler's thread.  `warmup` runs the engine's warm-up before the first
request.  Many queries per request share one text-tower batch.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20          # 1 MiB of JSON is ~thousands of queries
MAX_QUERIES_PER_REQUEST = 128     # largest query bucket (index.QUERY_BUCKETS)


class RetrievalServer:
    """Wraps a `RetrievalEngine` (with an attached index) in an HTTP server.

    Args:
        engine: RetrievalEngine with `engine.index` set.
        host, port: bind address; port=0 picks a free port.
        default_k: `k` used when a /search body omits it.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080,
                 default_k: int = 5):
        if engine.index is None:
            raise ValueError("engine has no index — build or load one first")
        self.engine = engine
        self.default_k = default_k
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- info
    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def _health(self) -> dict:
        idx = self.engine.index
        return {"ok": True, "videos": len(idx), "dim": idx.dim,
                "quantize": idx.quantize,
                "model": self.engine.model.cfg.clip_name,
                "sim_header": self.engine.model.cfg.sim_header}

    def _search(self, body: dict) -> dict:
        queries = body.get("queries")
        if isinstance(queries, str):
            queries = [queries]
        if (not isinstance(queries, list) or not queries
                or not all(isinstance(q, str) for q in queries)):
            raise ValueError('"queries" must be a non-empty list of strings')
        if len(queries) > MAX_QUERIES_PER_REQUEST:
            raise ValueError(
                f"at most {MAX_QUERIES_PER_REQUEST} queries per request")
        k = body.get("k", self.default_k)
        # bool subclasses int: {"k": true} must 400, not search with k=1
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise ValueError('"k" must be a positive integer')
        t0 = time.perf_counter()
        with self._lock:
            results = self.engine.search(queries, k=k)
        return {"results": results,
                "took_ms": round((time.perf_counter() - t0) * 1e3, 3)}

    # -------------------------------------------------------------- handler
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, payload: dict):
                raw = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                if self.path in ("/healthz", "/health"):
                    self._reply(200, server._health())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/search":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        # reply without reading the oversized body and drop
                        # the connection
                        self.close_connection = True
                        self._reply(413, {"error": "body too large"})
                        return
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    self._reply(200, server._search(body))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — report, don't die
                    logger.exception("search failed")
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def log_message(self, fmt, *args):
                logger.info("%s - %s", self.address_string(), fmt % args)

        return Handler

    # ------------------------------------------------------------ lifecycle
    def warmup(self, max_queries: int = MAX_QUERIES_PER_REQUEST) -> int:
        """Run the engine's warm-up (kernel libraries, the tokenizer, each
        query bucket up to the largest request the server admits) before
        the first request; returns the number of buckets warmed."""
        with self._lock:
            return self.engine.warmup(k=self.default_k,
                                      max_queries=max_queries)

    def start(self) -> "RetrievalServer":
        """Serve on a background thread (returns at once)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("retrieval server on http://%s:%d", *self.address)
        return self

    def serve_forever(self):
        """Blocking serve (the CLI `serve` command)."""
        logger.info("retrieval server on http://%s:%d", *self.address)
        self._httpd.serve_forever()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
