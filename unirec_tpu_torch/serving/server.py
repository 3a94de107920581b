"""JSON-over-HTTP recommendation server with cross-request micro-batching
(port of ``unirec_tpu/serving/server.py`` around the port's ``Recommender``).

POST /recommend   {"history": [item_id, ...], "k": 10}
                  -> {"items": [{"item_id": ..., "score": ...}, ...]}
POST /score       {"history": [...], "candidates": [...]}
                  -> {"ranking": [[item_id, score], ...]}
GET  /healthz     -> {"ok": true, "catalog_size": N, "batches_run": M, ...}

Concurrent ``/recommend`` requests coalesce into full fixed-shape batches in
``serving/batching.MicroBatcher``, whose single
dispatcher thread is the only one that drives the device.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from unirec_tpu_torch.serving.batching import MicroBatcher, ServerOverloaded
from unirec_tpu_torch.serving.recommender import Recommender


def make_handler(recommender: Recommender, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": "not found"})
                return
            self._send(200, {
                "ok": True,
                "catalog_size": len(recommender.catalog_ids),
                "batches_run": batcher.batches_run,
                "requests_served": batcher.requests_served,
                "device_time_s": batcher.device_time_s,
                "idle_time_s": batcher.idle_time_s,
                "submit_time_s": batcher.submit_time_s,
                "finalize_time_s": batcher.finalize_time_s,
                "requests_shed": batcher.requests_shed,
                "max_queued": batcher.max_queued,
                "handler_parse_s": batcher.handler_parse_s,
                "handler_wait_s": batcher.handler_wait_s,
                "handler_respond_s": batcher.handler_respond_s,
                "latency": batcher.latency_quantiles(),
            })

        def do_POST(self):
            t_in = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, OSError) as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            t_parsed = time.perf_counter()
            try:
                if self.path == "/recommend":
                    self._recommend(req, t_in, t_parsed)
                elif self.path == "/score":
                    ranking = recommender.score_candidates(
                        req.get("history", []), req.get("candidates", []))
                    self._send(200, {"ranking": ranking})
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # request boundary: report, keep serving
                self._send(500, {"error": str(e)})

        def _recommend(self, req: dict, t_in: float, t_parsed: float) -> None:
            history = req.get("history", [])
            if not isinstance(history, list):
                self._send(400, {"error": "history must be a list"})
                return
            try:
                k = int(req.get("k", 10))
            except (TypeError, ValueError):
                self._send(400, {"error": "k must be an integer"})
                return
            n = len(recommender.catalog_ids)
            if not 1 <= k <= n:
                self._send(400, {"error": f"k must be in [1, {n}]"})
                return
            try:
                recs = batcher.recommend(history, k=k)
            except ServerOverloaded as e:
                # shed at saturation: clients retry with backoff
                self._send(503, {"error": str(e)}, [("Retry-After", "1")])
                return
            t_done = time.perf_counter()
            self._send(200, {"items": [
                {"item_id": r.item_id, "score": r.score} for r in recs]})
            t_out = time.perf_counter()
            with batcher._acct:
                batcher.handler_parse_s += t_parsed - t_in
                batcher.handler_wait_s += t_done - t_parsed
                batcher.handler_respond_s += t_out - t_done

    return Handler


def make_server(recommender: Recommender, host: str = "127.0.0.1",
                port: int = 8099, warmup: bool = False,
                freeze_heap: bool = False, max_queued: int = None):
    """(server, batcher); the caller owns ``serve_forever``/``shutdown`` and
    ``batcher.close()``.  ``warmup=True`` runs one full batch (kernel build
    included) before returning, so the first request does not pay it.
    ``max_queued`` bounds the admission queue (default: two batches);
    requests beyond it are shed with 503."""
    batcher = MicroBatcher(recommender, max_queued=max_queued)
    if warmup:
        batcher.warmup()
    if freeze_heap:
        from unirec_tpu_torch.serving.host_tuning import freeze_host_heap

        freeze_host_heap()

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        # the stdlib backlog of 5 overflows under a burst of clients
        request_queue_size = 128

    server = _Server((host, port), make_handler(recommender, batcher))
    return server, batcher


def serve(recommender: Recommender, host: str = "127.0.0.1",
          port: int = 8099) -> None:
    server, batcher = make_server(recommender, host, port, warmup=True,
                                  freeze_heap=True)
    print(f"serving on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()
