"""Web GUI: static HTTP server + websocket control channel.

Counterpart of transflow_tpu/gui/server.py: an HTTP server (the standard
library's) for the static client (the port's own copy in ``static/``) and
media files (with range requests for scrubbing), a websocket server on a
random port discovered through /wss, and the protocol:

  client -> server: GENERATE {config json} | INTERRUPT | RELOAD |
                    FILE_OPEN <key> | FILE_SAVE <key>
  server -> client: STATUS {cursor,total,elapsed,error} | DONE [path] |
                    PREVIEW <url> | ERROR <msg> | FILE <key> <path>

The port's Pipeline runs in a thread (it spawns its own decode/encode
threads) on the server's device, the current CUDA device unless the caller
names another (``device="cpu"``), and streams its preview through an
MJPEG output placed first in the output list. websockets is imported when
the server starts, and where it is missing that raises an ``ImportError``
naming it.
"""
import asyncio
import json
import logging
import mimetypes
import os
import queue
import re
import socket
import threading
import urllib.parse
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

from ..utils.misc import require

logger = logging.getLogger(__name__)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("", 0))
        return probe.getsockname()[1]


class _GuiHTTPHandler(SimpleHTTPRequestHandler):
    """Static files + /media (range requests) + /wss + /ping."""

    server_version = "transflow-tpu-gui"
    ws_port = 0

    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/ping":
            self._respond(200, b"PONG", "text/plain")
            return
        if parsed.path == "/wss":
            self._respond(200, str(self.ws_port).encode(), "text/plain")
            return
        if parsed.path == "/media":
            query = urllib.parse.parse_qs(parsed.query)
            path = query.get("path", [None])[0]
            if path is None or not os.path.isfile(path):
                self._respond(404, b"not found", "text/plain")
                return
            self._serve_media(path)
            return
        self.directory = STATIC_DIR
        super().do_GET()

    def translate_path(self, path):
        path = urllib.parse.urlparse(path).path
        if path == "/":
            path = "/index.html"
        # sanitize: resolve and refuse anything escaping the static dir
        resolved = os.path.realpath(
            os.path.join(STATIC_DIR, path.lstrip("/")))
        if os.path.commonpath([resolved, STATIC_DIR]) != STATIC_DIR:
            return os.path.join(STATIC_DIR, "index.html")
        return resolved

    def _respond(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_media(self, path: str):
        """HTTP range support so the browser can scrub videos."""
        size = os.path.getsize(path)
        content_type = mimetypes.guess_type(path)[0] or \
            "application/octet-stream"
        range_header = self.headers.get("Range")
        start, end = 0, size - 1
        if range_header:
            m = re.match(r"bytes=(\d*)-(\d*)", range_header)
            if m:
                if m.group(1):
                    start = int(m.group(1))
                if m.group(2):
                    end = min(int(m.group(2)), size - 1)
        length = end - start + 1
        self.send_response(206 if range_header else 200)
        self.send_header("Content-Type", content_type)
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(length))
        if range_header:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        with open(path, "rb") as file:
            file.seek(start)
            remaining = length
            while remaining > 0:
                chunk = file.read(min(65536, remaining))
                if not chunk:
                    break
                try:
                    self.wfile.write(chunk)
                except (BrokenPipeError, ConnectionResetError):
                    break
                remaining -= len(chunk)


class GuiServer:

    def __init__(self, host: str = "localhost", port: int = 8000,
                 mjpeg_port: int = 8001, device=None):
        """``device``: where the jobs render, the current CUDA device by
        default (no card raises here); ``"cpu"`` renders on the CPU."""
        from .._device import resolve_device
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        self.mjpeg_port = mjpeg_port
        self.ws_port = _free_port()
        self.http_server: ThreadingHTTPServer | None = None
        self.ws_thread: threading.Thread | None = None
        self.http_thread: threading.Thread | None = None
        self._clients: set = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.pipeline = None
        self.cancel_event: threading.Event | None = None
        self.job_thread: threading.Thread | None = None
        self._ready = threading.Event()
        #: the user's file output of the current/last job (None when the
        #: job only streams) — echoed by RELOAD so a reloading client can
        #: re-link it (reference gui/server.py:157,222-227)
        self.output_file: str | None = None
        #: explicit job-state flag for RELOAD: cleared BEFORE the job
        #: thread broadcasts DONE/ERROR, so a client that reloads the
        #: instant it sees DONE never races the thread's own teardown
        #: (job_thread.is_alive() stays True a beat after the broadcast)
        self.job_ongoing = False

    # ------------------------------------------------------------------
    # websocket protocol
    # ------------------------------------------------------------------

    def _broadcast(self, message: str):
        if self._loop is None:
            return
        for client in list(self._clients):
            asyncio.run_coroutine_threadsafe(client.send(message), self._loop)

    async def _on_message(self, websocket, message: str):
        if message.startswith("GENERATE"):
            payload = json.loads(message[len("GENERATE"):].strip() or "{}")
            self._start_job(payload)
        elif message == "INTERRUPT":
            if self.cancel_event is not None:
                self.cancel_event.set()
                # reference broadcasts CANCEL after the interrupt so every
                # client resets its run state (gui/server.py:216-221)
                self._broadcast("CANCEL")
        elif message == "RELOAD":
            # state resync for a (re)loading client — the reference client
            # sends RELOAD on websocket open and the server answers with
            # the current job state (gui/server.py:222-227, master.js:524)
            await websocket.send("RELOAD " + json.dumps({
                "ongoing": self.job_ongoing,
                "outputFile": self.output_file,
                "previewUrl":
                    f"http://{self.host}:{self.mjpeg_port}/transflow",
            }))
        elif message.startswith("FILE_OPEN") or message.startswith(
                "FILE_SAVE"):
            await self._file_dialog(websocket, message)
        else:
            await websocket.send(f"ERROR unknown message: {message[:60]}")

    async def _file_dialog(self, websocket, message: str):
        """Native open/save dialogs (tkinter). Gated: headless
        environments answer with an error string."""
        parts = message.split(maxsplit=1)
        key = parts[1] if len(parts) > 1 else ""
        try:
            import tkinter
            import tkinter.filedialog
            root = tkinter.Tk()
            root.withdraw()
            if message.startswith("FILE_OPEN"):
                path = tkinter.filedialog.askopenfilename()
            else:
                path = tkinter.filedialog.asksaveasfilename()
            root.destroy()
            if path:
                await websocket.send(f"FILE {key} {path}")
        except Exception as err:  # noqa: BLE001 — headless gate
            await websocket.send(f"ERROR file dialog unavailable: {err}")

    def _start_job(self, payload: dict):
        from ..config import Config
        from ..pipeline import Pipeline
        if self.job_thread is not None and self.job_thread.is_alive():
            self._broadcast("ERROR a job is already running")
            return
        try:
            cfg = Config.fromdict(payload)
        except Exception as err:  # noqa: BLE001
            self._broadcast(f"ERROR bad config: {err}")
            return
        # prepend the mjpeg preview output (gui/server.py:154-159)
        outputs = [f"mjpeg:{self.mjpeg_port}"]
        if isinstance(cfg.output_path, list):
            outputs += cfg.output_path
        elif cfg.output_path is not None:
            outputs.append(cfg.output_path)
        cfg.output_path = outputs
        # first user file target (skip the mjpeg preview) for RELOAD resync
        self.output_file = next(
            (p for p in outputs[1:] if not str(p).startswith("mjpeg")), None)
        self.cancel_event = threading.Event()
        status_queue: queue.Queue = queue.Queue(maxsize=4)
        self.pipeline = Pipeline(
            cfg, safe=True, cancel_event=self.cancel_event,
            status_queue=status_queue, progress=False, execute=False,
            replace=False, device=self.device)

        def job():
            try:
                self.pipeline.run()
                # reference broadcasts DONE with the output file so the
                # client can link it (gui/server.py:214-215)
                produced = ""
                for thread in self.pipeline.output_threads:
                    path = thread.output.output_path
                    if path:
                        produced = path
                        break
                self.job_ongoing = False  # before the broadcast — see init
                self._broadcast(f"DONE {produced}".rstrip())
            except Exception as err:  # noqa: BLE001
                self.job_ongoing = False
                self._broadcast(f"ERROR {err}")

        def monitor():
            while self.job_thread.is_alive() or not status_queue.empty():
                try:
                    status = status_queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                self._broadcast("STATUS " + json.dumps({
                    "cursor": status.cursor,
                    "total": status.total,
                    "elapsed": status.elapsed,
                    "error": status.error,
                }))

        self.job_ongoing = True
        self.job_thread = threading.Thread(target=job, daemon=True,
                                           name="gui-job")
        self.job_thread.start()
        threading.Thread(target=monitor, daemon=True,
                         name="gui-monitor").start()
        self._broadcast(
            f"PREVIEW http://{self.host}:{self.mjpeg_port}/transflow")

    # ------------------------------------------------------------------
    # servers
    # ------------------------------------------------------------------

    async def _ws_handler(self, websocket):
        self._clients.add(websocket)
        try:
            async for message in websocket:
                try:
                    await self._on_message(websocket, message)
                except Exception as err:  # noqa: BLE001
                    logger.exception("websocket handler failed")
                    await websocket.send(f"ERROR {err}")
        finally:
            self._clients.discard(websocket)

    def _run_ws(self):
        import websockets
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        self._ws_stop = self._loop.create_future()

        async def serve():
            async with websockets.serve(self._ws_handler, self.host,
                                        self.ws_port):
                self._ready.set()
                await self._ws_stop

        try:
            self._loop.run_until_complete(serve())
        except RuntimeError:
            pass  # loop stopped

    def start(self, block: bool = True, open_browser: bool = True):
        # the control channel's thread imports it
        require("websockets", "the GUI's control channel")
        handler = type("Handler", (_GuiHTTPHandler,),
                       {"ws_port": self.ws_port})
        self.http_server = ThreadingHTTPServer((self.host, self.port),
                                               handler)
        self.http_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True,
            name="gui-http")
        self.http_thread.start()
        self.ws_thread = threading.Thread(target=self._run_ws, daemon=True,
                                          name="gui-ws")
        self.ws_thread.start()
        self._ready.wait(timeout=10)
        url = f"http://{self.host}:{self.port}"
        logger.info("GUI on %s (ws on :%d)", url, self.ws_port)
        if open_browser:
            try:
                import webbrowser
                webbrowser.open(url)
            except Exception:  # noqa: BLE001
                pass
        if block:
            try:
                self.http_thread.join()
            except KeyboardInterrupt:
                self.stop()
        return self

    def stop(self):
        if self.http_server is not None:
            self.http_server.shutdown()
        if self._loop is not None:
            def finish():
                if not self._ws_stop.done():
                    self._ws_stop.set_result(None)
            self._loop.call_soon_threadsafe(finish)
            if self.ws_thread is not None:
                self.ws_thread.join(timeout=5)


def start_gui(host: str = "localhost", port: int = 8000,
              mjpeg_port: int = 8001, block: bool = True,
              open_browser: bool = True, device=None) -> GuiServer:
    """Start the GUI (the ``gui`` action); ``device`` as ``GuiServer``'s."""
    server = GuiServer(host, port, mjpeg_port, device=device)
    return server.start(block=block, open_browser=open_browser)
