"""Live MJPEG frame streamer — the windowed-display analog.

The reference presents frames in a winit window with a fullscreen-quad
display pass (src/main.rs:264-1147, src/display.wgsl). A GPU server is
headless, so the real-time surface here is an HTTP stream any browser can
show: `python -m bhr_tpu.app --serve 8000` renders the orbit animation
and streams it as multipart/x-mixed-replace JPEG (MJPEG — the standard
motion-JPEG-over-HTTP framing every browser and VLC understands) at
http://localhost:8000/.

Design: one daemon-thread `http.server.ThreadingHTTPServer`; the render
loop pushes frames with `submit(rgba_u8)` (encoded to JPEG on the host,
off the device hot path, exactly like the PNG writeback), and each connected client's handler thread wakes on a
Condition and writes the newest frame. Slow clients skip frames rather
than applying backpressure to the render loop (always-latest semantics,
like a swapchain with Mailbox present mode).
"""

from __future__ import annotations

import io
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

_BOUNDARY = "bhrframe"

_INDEX_HTML = b"""<!doctype html>
<html><head><title>bhr_tpu live view</title><style>
 body { background: #000; margin: 0; display: flex; flex-direction: column;
        align-items: center; color: #aaa; font: 13px monospace; }
 img { max-width: 100vw; max-height: 95vh; image-rendering: pixelated; }
</style></head><body>
<img src="/stream" alt="render stream">
<p>bhr_tpu &mdash; live MJPEG stream (the reference's winit window,
headless)</p>
</body></html>
"""


class FrameStreamer:
    """Threaded MJPEG-over-HTTP publisher with always-latest semantics."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._seq = 0
        self._closed = False
        streamer = self

        class Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("viewer: " + fmt, *args)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_INDEX_HTML)))
                    self.end_headers()
                    self.wfile.write(_INDEX_HTML)
                    return
                if self.path != "/stream":
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
                )
                self.end_headers()
                last = -1
                try:
                    while True:
                        with streamer._cond:
                            streamer._cond.wait_for(
                                lambda: streamer._closed
                                or (
                                    streamer._jpeg is not None
                                    and streamer._seq != last
                                ),
                                timeout=5.0,
                            )
                            if streamer._closed:
                                return
                            if streamer._jpeg is None or streamer._seq == last:
                                continue  # keep-alive timeout; re-wait
                            jpeg, last = streamer._jpeg, streamer._seq
                        self.wfile.write(
                            b"--" + _BOUNDARY.encode() + b"\r\n"
                            b"Content-Type: image/jpeg\r\n"
                            b"Content-Length: "
                            + str(len(jpeg)).encode()
                            + b"\r\n\r\n"
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away; its thread just ends

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="bhr-viewer"
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        shown = "localhost" if host in ("127.0.0.1", "0.0.0.0") else host
        return f"http://{shown}:{port}/"

    def submit(self, rgba_u8) -> None:
        """Publish an (H, W, 4) or (H, W, 3) uint8 frame (host array)."""
        from PIL import Image

        img = Image.fromarray(rgba_u8[..., :3], mode="RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        with self._cond:
            self._jpeg = buf.getvalue()
            self._seq += 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()


def read_one_frame(host: str, port: int, timeout: float = 5.0) -> bytes:
    """Test helper: connect to /stream and return the first JPEG payload."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
        s.settimeout(timeout)
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
            start = data.find(b"\xff\xd8")  # JPEG SOI
            end = data.find(b"\xff\xd9", start + 2)  # EOI
            if start != -1 and end != -1:
                return data[start : end + 2]
    raise TimeoutError("no complete JPEG frame received")
