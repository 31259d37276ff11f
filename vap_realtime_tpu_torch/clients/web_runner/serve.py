"""Serve the web runner's folder over http (fetch() needs http, not
file://).

Port of `vap_realtime_tpu/clients/web_runner/serve.py`.  Write the
artifacts first (`python -m vap_realtime_tpu_torch.tools.export_web
--synthetic_weights`, into this folder's `artifacts/`), then

Run: python -m vap_realtime_tpu_torch.clients.web_runner.serve [port]
and open http://localhost:8619/ in a browser.
"""

from __future__ import annotations

import functools
import http.server
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def make_server(port: int = 8619, directory: str = HERE):
    """A threading HTTP server on 127.0.0.1:`port` (0: a free port) over
    `directory`; the caller runs serve_forever() and shutdown()."""
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=directory)
    return http.server.ThreadingHTTPServer(("127.0.0.1", port), handler)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    port = int(argv[0]) if argv else 8619
    make_server(port).serve_forever()


if __name__ == "__main__":
    main()
