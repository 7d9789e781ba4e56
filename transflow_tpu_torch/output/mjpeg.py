"""Embedded MJPEG streaming server output.

Counterpart of transflow_tpu/output/mjpeg.py: an aiohttp server on a
daemon thread serving ``/`` (a page with the stream) and ``/transflow``, a
``multipart/x-mixed-replace`` stream (boundary ``transflow-frame``) of the
latest frame, JPEG-encoded by ``cv2.imencode`` at quality 50; it is also
the GUI's preview channel. aiohttp and cv2 are imported where they are
used, and where either is missing ``open`` raises an ``ImportError``
naming it.
"""
import asyncio
import logging
import threading

import numpy as np

from ..utils.misc import require
from .video_output import VideoOutput

logger = logging.getLogger(__name__)

JPEG_QUALITY = 50
BOUNDARY = "transflow-frame"


class MjpegOutput(VideoOutput):

    ROUTE = "/transflow"

    def __init__(self, width: int, height: int, framerate: float,
                 port: int = 8080, host: str | None = None):
        super().__init__(width, height, framerate)
        self.port = port
        self.host = host or "0.0.0.0"
        self._latest: bytes | None = None
        self._frame_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._runner = None
        self._error: BaseException | None = None
        self._cv2 = None
        self._streams: set = set()  # the handlers' tasks, cancelled at close

    # -- server ----------------------------------------------------------

    async def _handler(self, request):
        from aiohttp import web
        response = web.StreamResponse(
            status=200,
            headers={"Content-Type":
                     f"multipart/x-mixed-replace;boundary={BOUNDARY}"})
        await response.prepare(request)
        self._streams.add(asyncio.current_task())
        try:
            while True:
                await self._frame_event.wait()
                self._frame_event.clear()
                data = self._latest
                if data is None:
                    continue
                header = (f"--{BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                          f"Content-Length: {len(data)}\r\n\r\n")
                await response.write(header.encode() + data + b"\r\n")
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self._streams.discard(asyncio.current_task())
        return response

    async def _index(self, request):
        from aiohttp import web
        return web.Response(
            text=f"<html><body><img src='{self.ROUTE}'/></body></html>",
            content_type="text/html")

    def _serve(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._frame_event = asyncio.Event()
        try:
            from aiohttp import web
            app = web.Application()
            app.router.add_get(self.ROUTE, self._handler)
            app.router.add_get("/", self._index)
            self._runner = web.AppRunner(app)
            self._loop.run_until_complete(self._runner.setup())
            site = web.TCPSite(self._runner, self.host, self.port)
            self._loop.run_until_complete(site.start())
        except Exception as err:  # noqa: BLE001 — raised by open()
            self._error = err
            self._started.set()
            return
        logger.info("MJPEG server on http://%s:%d%s", self.host, self.port,
                    self.ROUTE)
        self._started.set()
        self._loop.run_forever()

    # -- VideoOutput interface --------------------------------------------

    def open(self):
        require("aiohttp", "the MJPEG output")
        self._cv2 = require("cv2", "the MJPEG output")
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="mjpeg-server")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("MJPEG server failed to start")
        if self._error is not None:
            self._loop.close()
            self._loop = None
            raise RuntimeError(f"MJPEG server failed to start on "
                               f"{self.host}:{self.port}: {self._error}")
        self.output_path = None  # network output: no file on disk
        return self

    def feed(self, frame):
        cv2 = self._cv2
        frame = np.asarray(frame, dtype=np.uint8)
        ok, encoded = cv2.imencode(
            ".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
            [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
        if not ok:
            return
        self._latest = encoded.tobytes()
        if self._loop is not None and self._frame_event is not None:
            self._loop.call_soon_threadsafe(self._frame_event.set)

    def close(self):
        if self._loop is not None:
            loop = self._loop

            def shutdown():
                async def cleanup():
                    # a client that went away leaves its handler waiting
                    # for the next frame: stop it, or the cleanup waits
                    for task in list(self._streams):
                        task.cancel()
                    if self._runner is not None:
                        await self._runner.cleanup()
                    loop.stop()
                loop.create_task(cleanup())

            loop.call_soon_threadsafe(shutdown)
            self._thread.join(timeout=5)
            if not loop.is_running():
                loop.close()
            self._loop = None

