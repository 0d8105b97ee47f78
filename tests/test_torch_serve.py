"""The port's own ``serve/server.py``, held against the JAX package's.

* ``parse_multipart`` gives the JAX parser's fields on the same bodies;
* ``DetectionService.handle_photo`` over the port's ``Pipeline`` answers
  the same JSON as the JAX service over the JAX ``Pipeline`` (tiny seeded
  members from ``test_torch_pipeline``), error paths included;
* over HTTP on localhost, ``POST /photo`` answers that JSON and
  ``GET /health`` reports the service;
* admission and drain cannot race: a request whose admission is under way
  when a drain begins is either counted in flight and waited for, or
  refused with 503.  The test holds the request inside its admission with
  ``threading.Event``s while the drain starts.
"""
import http.client
import json
import threading
import uuid
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from building_detection_tpu.serve import server as JS
from building_detection_tpu_torch.serve import server as PS
from test_golden import CFG
from test_torch_cuda import scenes
from test_torch_pipeline import jax_pipeline, png, port_pipeline

BOUNDARY = "----bdt" + "0" * 8


def multipart(fields, boundary=BOUNDARY):
    """``fields``: name -> (filename or None, payload bytes)."""
    out = b""
    for name, (filename, payload) in fields.items():
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename is not None else "")
        out += f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode() + payload + b"\r\n"
    return out + f"--{boundary}--\r\n".encode()


BODIES = {
    "file": (multipart({"file": ("a.png", b"\x89PNG\r\n-data-")}), f"multipart/form-data; boundary={BOUNDARY}"),
    "payload-ends-in-crlf": (multipart({"file": ("b.png", b"xyz\r\n\r\n")}), f"multipart/form-data; boundary={BOUNDARY}"),
    "two-fields": (multipart({"note": (None, b"hello"), "file": ("c d.png", bytes(range(256)))}),
                   f'multipart/form-data; boundary="{BOUNDARY}"'),
    "empty-payload": (multipart({"file": ("e.png", b"")}), f"multipart/form-data; boundary={BOUNDARY}"),
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_parse_multipart_matches_jax(body):
    data, ctype = BODIES[body]
    assert PS.parse_multipart(data, ctype) == JS.parse_multipart(data, ctype)


def test_parse_multipart_needs_a_boundary():
    for parse in (PS.parse_multipart, JS.parse_multipart):
        with pytest.raises(ValueError, match="boundary"):
            parse(b"", "multipart/form-data")


@pytest.fixture(scope="module")
def pipelines():
    return port_pipeline(), jax_pipeline()


@pytest.fixture
def services(pipelines, tmp_path):
    port_pipe, jax_pipe = pipelines
    port = PS.DetectionService(port_pipe, CFG, root_dir=str(tmp_path / "port"))
    jax_service = JS.DetectionService(jax_pipe, CFG, root_dir=str(tmp_path / "jax"))
    yield port, jax_service
    port.drain(timeout_s=30)
    jax_service.drain(timeout_s=30)


def test_handle_photo_matches_jax(services):
    port, jax_service = services
    for i, img in enumerate(scenes(5, [(200, 260), (120, 170), (10, 12)])):
        got = port.handle_photo("10_0_0_2", f"scene{i}.png", png(img))
        want = jax_service.handle_photo("10_0_0_2", f"scene{i}.png", png(img))
        assert got["status"] == "success", got["error"]
        assert got == want
    assert got["points"] == {}  # the 10x12 scene has no tile


@pytest.mark.parametrize("case", ["no-payload", "no-filename", "bad-client", "not-an-image"])
def test_handle_photo_errors_match_jax(services, case):
    client, filename, payload = {
        "no-payload": ("c1", "a.png", b""),
        "no-filename": ("c1", "", b"x"),
        "bad-client": ("../..", "a.png", b"x"),
        "not-an-image": ("c1", "a.png", b"not a png"),
    }[case]
    port, jax_service = services
    got = port.handle_photo(client, filename, payload)
    want = jax_service.handle_photo(client, filename, payload)
    assert got["status"] == "NG" and got["data"] is None and got["points"] == {}
    if case == "not-an-image":  # the exception's repr names the upload's random file name
        assert got["error"].split("(")[0] == want["error"].split("(")[0]
    else:
        assert got == want


def test_health_matches_jax(services):
    port, jax_service = services
    (got, code), (want, want_code) = port.health(), jax_service.health()
    assert code == want_code == 200
    assert {k: v for k, v in got.items() if k != "model"} == {k: v for k, v in want.items() if k != "model"}
    assert got["model"] == "Pipeline"


class Server:
    """``make_handler(service)`` on 127.0.0.1 with an ephemeral port, in a thread."""

    def __init__(self, service):
        self.service = service
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), PS.make_handler(service))
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=b"", headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.httpd.server_address[1], timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def photo(self, img, client="10_0_0_3"):
        body = multipart({"file": ("scene.png", png(img))})
        return self.request("POST", "/photo", body, {
            "Content-Type": f"multipart/form-data; boundary={BOUNDARY}", "clientID": client,
        })

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_http_photo_health_and_drain(services):
    port, jax_service = services
    server = Server(port)
    try:
        (img,) = scenes(6, [(200, 260)])
        code, got = server.photo(img)
        assert code == 200 and got == jax_service.handle_photo("10_0_0_3", "scene.png", png(img))
        code, health = server.request("GET", "/health")
        assert code == 200 and health["status"] == "ok" and health["inflight"] == 0
        assert server.request("GET", "/nowhere")[0] == 404
        assert port.drain(timeout_s=30) is True
        code, refused = server.photo(img)
        assert code == 503 and refused["error"] == "server is draining"
        code, health = server.request("GET", "/health")
        assert code == 503 and health["status"] == "draining"
    finally:
        server.close()


class HeldAdmission(PS.DetectionService):
    """A service whose ``draining`` flag, read during a request's admission,
    records whether ``_inflight_cv`` is held at that moment and then waits
    for ``go``: the request stays inside its admission while the test starts
    a drain."""

    def __init__(self, *a, **kw):
        self.checked, self.go, self.lock_held = threading.Event(), threading.Event(), []
        self._armed = False
        super().__init__(*a, **kw)

    @property
    def draining(self):
        value = self._draining
        if self._armed and threading.current_thread().name.startswith("request"):
            self._armed = False
            probe = threading.Thread(target=lambda: self.lock_held.append(not self._try_lock()))
            probe.start()
            probe.join(timeout=30)
            self.checked.set()
            assert self.go.wait(timeout=30)
        return value

    @draining.setter
    def draining(self, value):
        self._draining = value

    def _try_lock(self):
        if self._inflight_cv.acquire(blocking=False):
            self._inflight_cv.release()
            return True
        return False


def test_drain_while_a_request_is_being_admitted(pipelines, tmp_path):
    service = HeldAdmission(pipelines[0], CFG, root_dir=str(tmp_path))
    server = Server(service)
    try:
        (img,) = scenes(7, [(120, 170)])
        answers, drained = [], []
        service._armed = True
        request = threading.Thread(target=lambda: answers.append(server.photo(img)), name="client")
        # the handler thread, not the client, runs the admission: name the server's threads
        server.httpd.daemon_threads = True
        original = server.httpd.process_request_thread

        def named(req, addr):
            threading.current_thread().name = f"request-{uuid.uuid4().hex[:6]}"
            original(req, addr)

        server.httpd.process_request_thread = named
        request.start()
        assert service.checked.wait(timeout=30), "the request never reached its admission"
        drain_called = threading.Event()

        def drain():
            drain_called.set()
            drained.append(service.drain(timeout_s=60))

        drainer = threading.Thread(target=drain)
        drainer.start()
        assert drain_called.wait(timeout=30)
        service.go.set()
        request.join(timeout=60)
        drainer.join(timeout=60)
        assert not request.is_alive() and not drainer.is_alive()
        assert service.lock_held == [True], "the draining check ran outside _inflight_cv"
        (code, answer), = answers
        assert code == 200 and answer["status"] == "success", answer
        assert drained == [True]
        code, refused = server.photo(img)
        assert code == 503 and refused["error"] == "server is draining"
    finally:
        service.go.set()
        server.close()
