"""PyTorch port, ``serve/client.py`` (``bdt-client``), held against the JAX client.

* with the boundary fixed (``uuid.uuid4`` patched), ``encode_multipart``
  writes the JAX client's bodies byte for byte, and the port's server
  parses them back;
* ``detect`` against the port's server (``make_handler`` over the port's
  ``Pipeline`` with tiny seeded members, on 127.0.0.1) returns the JSON the
  JAX client's ``detect`` returns, and writes the same result image;
* ``main`` prints the JAX client's line and exits 0 on success, 1 on NG;
* the client id is the local address on the route to the server, which
  for a server on 127.0.0.1 is ``127_0_0_1``.  No test reaches any other
  host: the JAX client's own ``local_client_id`` (a route to a public
  address) is never called.
"""
import json
import uuid

import pytest

from building_detection_tpu.serve import client as jax_client
from building_detection_tpu_torch.serve import client as port_client
from building_detection_tpu_torch.serve import server as PS
from test_golden import CFG
from test_torch_cuda import scenes
from test_torch_pipeline import png, port_pipeline
from test_torch_serve import Server

PAYLOADS = {
    "png": ("a.png", b"\x89PNG\r\n\x1a\n-data-"),
    "crlf-tail": ("b.tif", b"xyz\r\n\r\n"),
    "spaces-and-bytes": ("c d.png", bytes(range(256))),
    "empty": ("e.png", b""),
}


@pytest.fixture
def fixed_boundary(monkeypatch):
    fixed = uuid.UUID(int=0x1234567890ABCDEF1234567890ABCDEF)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    return fixed.hex


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_encode_multipart_equals_jax(fixed_boundary, payload):
    filename, data = PAYLOADS[payload]
    got = port_client.encode_multipart("file", filename, data)
    assert got == jax_client.encode_multipart("file", filename, data)
    assert got[1] == f"multipart/form-data; boundary={fixed_boundary}"
    assert PS.parse_multipart(*got) == {"file": (filename, data)}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    srv = Server(PS.DetectionService(port_pipeline(), CFG, root_dir=str(root)))
    yield srv, root
    srv.service.drain(timeout_s=30)
    srv.close()


def image_file(tmp_path, i, shape=(200, 260)):
    (img,) = scenes(20 + i, [shape])
    path = tmp_path / f"scene{i}.png"
    path.write_bytes(png(img))
    return str(path)


@pytest.mark.parametrize("shape", [(200, 260), (120, 170), (10, 12)], ids=["two-tiles", "one-tile", "no-tile"])
def test_detect_returns_the_jax_clients_answer(server, tmp_path, shape):
    srv, _ = server
    url = f"http://127.0.0.1:{srv.httpd.server_address[1]}/photo"
    path = image_file(tmp_path, shape[0], shape)
    got = port_client.detect(path, url=url, client_id="10_0_0_7", save_result_to=str(tmp_path / "port.png"))
    want = jax_client.detect(path, url=url, client_id="10_0_0_7", save_result_to=str(tmp_path / "jax.png"))
    assert got["status"] == "success", got["error"]
    assert got == want
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_client_id_is_the_address_on_the_route_to_the_server(server, tmp_path):
    srv, root = server
    assert port_client.local_client_id("127.0.0.1") == "127_0_0_1"
    url = f"http://127.0.0.1:{srv.httpd.server_address[1]}/photo"
    assert port_client.detect(image_file(tmp_path, 3), url=url)["status"] == "success"
    assert (root / "all_result" / "127_0_0_1" / "result.png").exists()


def test_main_prints_the_jax_clients_line(server, tmp_path, capsys, monkeypatch):
    srv, _ = server
    url = f"http://127.0.0.1:{srv.httpd.server_address[1]}/photo"
    monkeypatch.setattr(jax_client, "local_client_id", lambda: "127_0_0_1")  # never the public route
    path = image_file(tmp_path, 4)
    assert port_client.main([path, "--url", url, "--save", str(tmp_path / "p.png")]) == 0
    got = capsys.readouterr().out
    assert jax_client.main([path, "--url", url, "--save", str(tmp_path / "j.png")]) == 0
    assert got == capsys.readouterr().out
    line = json.loads(got)
    assert line["status"] == "success" and line["data"].endswith("b64 chars>")
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    assert port_client.main([str(bad), "--url", url]) == jax_client.main([str(bad), "--url", url]) == 1
    got, want = capsys.readouterr().out.splitlines()
    assert json.loads(got)["status"] == json.loads(want)["status"] == "NG"
    # the error names the upload's random file name: compare up to it
    assert json.loads(got)["error"].split("(")[0] == json.loads(want)["error"].split("(")[0]
