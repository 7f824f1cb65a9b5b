"""Live Prometheus scrape endpoint over a metrics-render callable.

Anything with a ``prometheus()``-shaped renderer (a serving engine)
serves its text exposition at ``GET /metrics`` from a stdlib
``ThreadingHTTPServer`` on a daemon thread — no dependencies, no
event loop, nothing the serving engine has to yield to. The render
callable runs on the scrape thread; engine counters are plain Python
ints/floats mutated under the GIL, so a scrape mid-round reads a
slightly stale but internally ordinary snapshot and never blocks the
scheduler.

    srv = MetricsServer(engine.prometheus, port=9100).start()
    ...
    srv.close()      # graceful: unbinds the socket, joins the thread

``port=0`` binds an ephemeral port (``srv.port`` reports the real one)
— the shape the shutdown test uses.

Where rendering is a collective (a composed dp x tp stack's merged
metrics, which every rank must render together), the scrape thread must
not render: a :class:`MetricsSnapshot` holds the text the serving loop
last rendered, every rank refreshing it at the same point of each round
(``stream(on_round=snap.refresh)``), and the server on rank 0 serves it,
at most a round old.

    snap = MetricsSnapshot(router.prometheus)        # every rank
    srv = MetricsServer(snap, port=9100).start()     # rank 0
    for out in router.stream(on_round=snap.refresh): ...
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

__all__ = ["MetricsServer", "MetricsSnapshot"]

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve ``render()`` at ``GET /metrics`` until :meth:`close`."""

    def __init__(self, render: Callable[[], str], port: int = 0,
                 host: str = "127.0.0.1"):
        self.render = render

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                        # noqa: N802 (stdlib API)
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "try /metrics")
                    return
                try:
                    body = outer.render().encode("utf-8")
                except Exception as exc:  # scrape must not kill the server
                    self.send_error(500, f"render failed: {exc!r}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep scrapes off stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self.host = host
        self.port = self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        """Graceful shutdown: stop accepting, unbind the socket, join
        the serve thread. Idempotent."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class MetricsSnapshot:
    """The text of ``render()`` as of the last :meth:`refresh` (one at
    construction); calling it returns that text without rendering, so a
    scrape thread never runs ``render``."""

    def __init__(self, render: Callable[[], str]):
        self.render = render
        self.text = render()

    def refresh(self) -> None:
        self.text = self.render()       # one reference swap: a scrape reads old or new

    def __call__(self) -> str:
        return self.text
