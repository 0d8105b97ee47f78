"""HTTP serving with the reference's exact JSON contract, on stdlib http.server.

Rebuild of `reference/buildAPI.py`: ``POST /photo`` with a ``clientID``
header and a multipart ``file`` field runs the full ensemble + fusion + edge
extraction and responds::

    {"status": "success", "data": "<base64 result.png>",
     "points": {"0": "x,y x,y ...", ...}, "error": "None"}

Error paths return ``{"status": "NG", "data": null, "points": {}, "error": ...}``
(`buildAPI.py:100-102,148-149`).  Differences from the reference, documented:

* Flask is replaced by ``http.server`` (the standard library needs no extra
  dependency, and the reference runs Flask's single-threaded dev server
  anyway);
* ``data`` is a base64 *string* — the reference stuffs a ``bytes`` object
  into its JSON (`buildAPI.py:123-126`), which only serialised on the
  historical Flask 1.x stack;
* models are loaded once at server construction (`buildAPI.py:78`);
* ``clientID`` is validated (``[A-Za-z0-9._-]`` only, no traversal) before it
  touches the filesystem — the reference joins it into a path unchecked
  (`buildAPI.py:86-92`); IP-derived IDs from the reference client
  (`CLient/Client.py:8-24`) always pass;
* uploads get a per-request unique filename — the reference keys the shared
  ``receive_file/`` drop dir by client basename (`buildAPI.py:104-109`), so
  two concurrent uploads named ``a.png`` would race and could swap results;
* concurrent requests are **micro-batched**: the device worker coalesces all
  queued scenes into one pipelined ``predict_images`` call instead of
  serialising full round-trips per request (the reference runs Flask's
  single-threaded dev server, one full ensemble per request,
  `buildAPI.py:233`).

The port's own copy of ``building_detection_tpu/serve/server.py``, serving
the port's :class:`~building_detection_tpu_torch.infer.pipeline.Pipeline`
with the port's :class:`~building_detection_tpu_torch.core.config.Config`.
One change: admission and drain cannot race.  A request's draining check and
its in-flight count are one step under ``_inflight_cv``
(:meth:`DetectionService.admit`), and :meth:`DetectionService.drain` flips
the flag under the same lock, so a request admitted just before a drain is
waited for, and one that arrives after it is refused with 503.
"""
from __future__ import annotations

import base64
import contextlib
import json
import os
import re
import shutil
import threading
import time as _time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


from building_detection_tpu_torch.core.config import Config
from building_detection_tpu_torch.utils import io as uio

_CLIENT_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Minimal multipart/form-data parser: field -> (filename, payload)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts = body.split(b"--" + boundary)
    out: Dict[str, Tuple[str, bytes]] = {}
    for part in parts[1:-1]:
        part = part.lstrip(b"\r\n")
        if not part or part in (b"--", b"--\r\n"):
            continue
        try:
            header_blob, payload = part.split(b"\r\n\r\n", 1)
        except ValueError:
            continue
        # exactly ONE CRLF separates the payload from the next boundary;
        # payloads may legitimately end in newline bytes themselves
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        headers = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        if name_m:
            out[name_m.group(1)] = (
                file_m.group(1) if file_m else "",
                payload,
            )
    return out


class ServiceDraining(RuntimeError):
    """Raised by :meth:`DetectionService.admit` once a drain has begun."""


class _Job:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _MicroBatcher:
    """Coalesces concurrent prediction requests into pipelined device calls.

    Requests that arrive while the device is busy queue up; when the worker
    frees, it drains the whole queue (up to ``max_batch``) into ONE
    ``predict_images`` call, whose scenes pipeline uploads/compute/downloads
    (`infer/fused_ensemble.py::predict_masks_many`).  Falls back to per-image
    calls for pipelines without ``predict_images``.
    """

    def __init__(self, pipeline, max_batch: int = 16):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self._queue: List[_Job] = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, image):
        job = _Job(image)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(job)
            self._cv.notify()
        job.event.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                jobs, self._queue = (
                    self._queue[: self.max_batch],
                    self._queue[self.max_batch:],
                )
            try:
                if len(jobs) > 1 and hasattr(self.pipeline, "predict_images"):
                    results = self.pipeline.predict_images(
                        [j.image for j in jobs]
                    )
                    if len(results) != len(jobs):
                        # a silent zip truncation here would hand the
                        # unpaired waiters result=None with no error
                        raise RuntimeError(
                            f"predict_images returned {len(results)} results "
                            f"for {len(jobs)} scenes"
                        )
                    for job, res in zip(jobs, results):
                        job.result = res
                else:
                    for job in jobs:
                        job.result = self.pipeline.predict_image(job.image)
            except BaseException as e:  # propagate to every waiter in the batch
                for job in jobs:
                    if job.result is None:
                        job.error = e
            finally:
                for job in jobs:
                    job.event.set()


class DetectionService:
    """The request-handling core, separated from HTTP plumbing for testing."""

    def __init__(self, pipeline, cfg: Config = Config(), root_dir: str = "."):
        self.pipeline = pipeline
        self.cfg = cfg
        self.receive_dir = os.path.join(root_dir, cfg.serve.receive_dir)
        self.result_dir = os.path.join(root_dir, cfg.serve.result_dir)
        os.makedirs(self.receive_dir, exist_ok=True)
        os.makedirs(self.result_dir, exist_ok=True)
        self._dir_lock = threading.Lock()
        # ops state (beyond the reference, which exposes neither liveness
        # nor a shutdown story — `buildAPI.py:233` is a bare app.run):
        # in-flight request count + a draining flag, so GET /health can
        # answer without running an inference and SIGTERM can finish
        # in-flight work before the process exits.
        self.draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # serialize same-client requests end-to-end: handle_photo rmtree's
        # and re-creates the per-client dir per request (the reference's
        # del_file, `buildAPI.py:92`), so without this a concurrent request
        # from ONE client could delete the dir while another is writing its
        # result (the reference is single-threaded; this server is not).
        # clientID is unauthenticated input, so the table is LRU-bounded:
        # idle entries (refcount 0) are evicted past _MAX_CLIENT_LOCKS;
        # in-use entries are pinned so two live requests from one client can
        # never see different lock objects.
        self._client_locks: "dict[str, list]" = {}  # id -> [lock, refcount]
        self._batcher = _MicroBatcher(pipeline)

    _MAX_CLIENT_LOCKS = 1024

    @contextlib.contextmanager
    def _client_lock(self, client_id: str):
        with self._dir_lock:
            entry = self._client_locks.pop(client_id, None) or [
                threading.Lock(), 0,
            ]
            entry[1] += 1
            self._client_locks[client_id] = entry  # re-insert = LRU touch
            if len(self._client_locks) > self._MAX_CLIENT_LOCKS:
                for cid in list(self._client_locks):
                    if len(self._client_locks) <= self._MAX_CLIENT_LOCKS:
                        break
                    if cid != client_id and self._client_locks[cid][1] == 0:
                        del self._client_locks[cid]
        try:
            with entry[0]:
                yield
        finally:
            with self._dir_lock:
                entry[1] -= 1

    @contextlib.contextmanager
    def admit(self):
        """Count one request in flight for its whole body, or raise
        :class:`ServiceDraining`.  The check and the count are one step
        under ``_inflight_cv``, which :meth:`drain` holds to flip the flag,
        so no request slips in between a drain's flag and its wait."""
        with self._inflight_cv:
            if self.draining:
                raise ServiceDraining("server is draining")
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def health(self) -> Tuple[dict, int]:
        """Cheap liveness/readiness: no inference, no locks on the hot path.

        503 while draining so a load balancer stops routing new work here
        before the listener closes."""
        draining = self.draining
        with self._batcher._cv:
            queued = len(self._batcher._queue)
        return (
            {
                "status": "draining" if draining else "ok",
                "inflight": self._inflight,
                "queued": queued,  # device-worker backlog (micro-batcher)
                "model": type(self.pipeline).__name__,
            },
            503 if draining else 200,
        )

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop admitting work, wait for in-flight requests, close the batcher.

        Returns True if every in-flight request finished inside ``timeout_s``
        (None = wait forever).  Safe to call more than once."""
        with self._inflight_cv:
            self.draining = True
            done = self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout_s
            )
        # jobs already queued still complete (the worker drains its queue
        # before exiting); only NEW predict calls raise after this
        self._batcher.close()
        return done

    @staticmethod
    def _ng(error: str) -> dict:
        return {"status": "NG", "data": None, "points": {}, "error": str(error)}

    def _user_dir(self, client_id: str) -> str:
        """Per-client result dir (`buildAPI.py:86-92`) — traversal-proof.

        The reference trusts the clientID header verbatim in a path join; a
        hostile ID like ``../..`` would have let a network client recursively
        delete arbitrary directories.  IDs are restricted to the charset the
        reference's own client emits (`CLient/Client.py:8-24`).
        """
        if not _CLIENT_ID_RE.match(client_id) or client_id in (".", ".."):
            raise ValueError(f"invalid clientID {client_id!r}")
        user_path = os.path.join(self.result_dir, client_id)
        root = os.path.realpath(self.result_dir)
        if os.path.commonpath([root, os.path.realpath(user_path)]) != root:
            raise ValueError(f"invalid clientID {client_id!r}")
        return user_path

    def handle_photo(
        self, client_id: Optional[str], filename: Optional[str], payload: Optional[bytes]
    ) -> dict:
        """The `/photo` flow (`buildAPI.py:82-149`)."""
        try:
            if not payload:
                return self._ng("传入的图片错误")
            if not filename:
                return self._ng("传入的图片名字为空")
            client_id = client_id or "anonymous"
            user_path = self._user_dir(client_id)
            # hold the client's lock across dir reset -> predict -> result
            # write: two concurrent requests from ONE client serialize
            # instead of one deleting the dir the other is writing into
            # (cross-client requests still run concurrently and micro-batch)
            with self._client_lock(client_id):
                if os.path.exists(user_path):
                    shutil.rmtree(user_path)  # del_file per request (buildAPI.py:92)
                os.makedirs(user_path, exist_ok=True)

                # save the upload (buildAPI.py:104-109) under a per-request
                # unique name so concurrent same-named uploads can't collide
                base = os.path.basename(filename) or "upload"
                file_path = os.path.join(
                    self.receive_dir, f"{uuid.uuid4().hex[:8]}_{base}"
                )
                with open(file_path, "wb") as f:
                    f.write(payload)

                image = uio.imread_rgb(file_path)
                result = self._batcher.predict(image)

                result_path = os.path.join(user_path, "result.png")
                uio.imwrite(result_path, result.fused)
                with open(result_path, "rb") as f:
                    data_b64 = base64.b64encode(f.read()).decode("ascii")

            points = uio.points_dict(result.corners)
            return {
                "status": "success",
                "data": data_b64,
                "points": points,
                "error": "None",
            }
        except Exception as e:  # broad catch mirrors buildAPI.py:148-149
            return self._ng(repr(e))


def make_handler(service: DetectionService):
    scfg = service.cfg.serve

    class Handler(BaseHTTPRequestHandler):
        # per-socket-op deadline (socketserver applies it in setup()): a
        # client that stops sending mid-headers or mid-body times out instead
        # of pinning the worker thread forever.  The reference's Flask dev
        # server was equally naive (`buildAPI.py:104-109`).
        timeout = scfg.request_timeout_s

        def log_message(self, fmt, *args):  # quiet
            pass

        def _respond(self, payload: dict, code: int = 200) -> None:
            blob = json.dumps(payload, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _read_body(self, length: int) -> bytes:
            """Read exactly ``length`` bytes under an OVERALL deadline.

            The per-recv socket timeout alone only bounds the gap between
            bytes — a drip-feeding client resets it with one byte per
            interval, and ``rfile.read(n)`` blocks inside BufferedReader
            until all ``n`` bytes arrive, so a Python-level deadline check
            between chunks is not enough either.  Before each chunk the
            SOCKET timeout is shrunk to the remaining overall deadline:
            whichever recv is in progress when the deadline passes raises,
            whatever the drip rate.  The original per-op timeout is restored
            afterwards for the response write / keep-alive reads."""
            deadline = _time.monotonic() + scfg.request_timeout_s
            chunks, remaining = [], length
            try:
                while remaining > 0:
                    left = deadline - _time.monotonic()
                    if left <= 0:
                        raise TimeoutError(
                            f"request body not received within "
                            f"{scfg.request_timeout_s:.0f}s"
                        )
                    self.connection.settimeout(min(left, scfg.request_timeout_s))
                    # read1: returns as soon as ANY bytes are available (one
                    # raw recv past the buffer) instead of blocking until a
                    # full fixed-size chunk arrives — so this loop, and the
                    # deadline check above, run at the client's arrival rate.
                    # Fast clients still move ~one socket buffer per call.
                    chunk = self.rfile.read1(remaining)
                    if not chunk:
                        raise ConnectionError("client closed mid-body")
                    chunks.append(chunk)
                    remaining -= len(chunk)
            finally:
                with contextlib.suppress(OSError):
                    self.connection.settimeout(scfg.request_timeout_s)
            return b"".join(chunks)

        def do_GET(self):
            if self.path != "/health":
                self._respond(service._ng(f"unknown path {self.path}"), 404)
                return
            payload, code = service.health()
            self._respond(payload, code)

        def do_POST(self):
            if self.path != "/photo":
                self._respond(service._ng(f"unknown path {self.path}"), 404)
                return
            try:
                # admitted before anything is read: a draining server refuses
                # at once (ServiceDraining below)
                with service.admit():
                    try:
                        length = int(self.headers.get("Content-Length", "0"))
                    except ValueError:
                        self._respond(service._ng("invalid Content-Length"), 400)
                        return
                    if length > scfg.max_request_bytes:
                        # reject BEFORE reading: no allocation proportional
                        # to the declared size, and drop the connection so
                        # the client can't keep streaming the oversized body
                        self.close_connection = True
                        self._respond(
                            service._ng(
                                f"request body {length} bytes exceeds limit "
                                f"{scfg.max_request_bytes}"
                            ),
                            413,
                        )
                        return
                    body = self._read_body(length)
                    fields = parse_multipart(
                        body, self.headers.get("Content-Type", "")
                    )
                    filename, payload = fields.get("file", (None, None))
                    client_id = self.headers.get("clientID")
                    self._respond(
                        service.handle_photo(client_id, filename, payload)
                    )
            except ServiceDraining as e:
                # the listener is about to close and the micro-batcher will
                # not accept new work
                self.close_connection = True
                self._respond(service._ng(str(e)), 503)
            except (TimeoutError, ConnectionError, OSError) as e:
                # stalled/broken upload: free the worker; answering may
                # itself fail on a dead socket, which is fine
                self.close_connection = True
                with contextlib.suppress(OSError):
                    self._respond(service._ng(repr(e)), 408)
            except Exception as e:
                self._respond(service._ng(repr(e)))

    return Handler


def serve(
    pipeline,
    cfg: Config = Config(),
    root_dir: str = ".",
    host=None,
    port=None,
    warmup: bool = True,
):
    """Blocking server on the reference's port 5001 (`buildAPI.py:233`).

    ``warmup`` runs one dummy tile through the ensemble before accepting
    requests, so the first client does not pay the first call's set-up
    (kernel builds, cuDNN algorithm choice).

    SIGTERM/SIGINT drain gracefully: mark draining (GET /health flips to
    503 so load balancers stop routing here), stop accepting connections,
    finish every in-flight request (bounded by ``serve.drain_timeout_s``),
    close the micro-batcher, then return.  The reference's bare ``app.run``
    (`buildAPI.py:233`) kills in-flight requests on the spot."""
    import signal

    service = DetectionService(pipeline, cfg, root_dir)
    if warmup:
        import numpy as np

        tile = cfg.tiler.tile
        print("warming up the ensemble...")
        pipeline.predict_image(np.zeros((tile, tile, 3), np.uint8))
        print("warm.")
    host = host if host is not None else cfg.serve.host
    port = port if port is not None else cfg.serve.port
    httpd = ThreadingHTTPServer((host, port), make_handler(service))

    def _graceful(signum, frame):
        # shutdown() must not run on the thread blocked in serve_forever
        # (it waits for that loop to exit); hand it to a helper thread.
        def run():
            print(f"signal {signum}: draining...", flush=True)
            service.draining = True
            httpd.shutdown()

        threading.Thread(target=run, daemon=True).start()

    # signal handlers are a main-thread-only API; embedded servers (serve()
    # on a worker thread) still drain via the finally below when their
    # httpd is shut down programmatically
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _graceful)
    # report the BOUND address (port=0 binds an ephemeral port)
    print(f"serving on {host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        done = service.drain(cfg.serve.drain_timeout_s)
        httpd.server_close()
        print(
            "drained, bye." if done
            else f"drain timed out after {cfg.serve.drain_timeout_s:.0f}s"
        )
