"""HTTP client of the detection service: ``bdt-client``, standard library only.

    python -m building_detection_tpu_torch.serve.client scene.png --url http://127.0.0.1:5001/photo --save out.png

The counterpart of ``building_detection_tpu/serve/client.py`` (itself the
reference's `CLient/Client.py`): the image goes up as the multipart field
``file`` with a ``clientID`` header, the JSON answer comes back, and the
base64 result image is written where ``--save`` says.  The bodies are the
JAX client's byte for byte.

The client id differs in how the local address is found: the JAX client
takes the source address of a route to a public host (8.8.8.8); this one
takes the source address of the route to the server it is about to call,
which is the address the server sees and asks nothing of any other host.
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import socket
import urllib.parse
import urllib.request
import uuid
from typing import Optional, Tuple


def local_client_id(server_host: str = "127.0.0.1") -> str:
    """The local address on the route to ``server_host``, dots replaced by
    underscores (`Client.py:8-24`).  Connecting a UDP socket sends no
    packet; ``127_0_0_1`` when there is no route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((server_host, 80))
            ip = s.getsockname()[0]
    except OSError:
        ip = "127.0.0.1"
    return ip.replace(".", "_")


def encode_multipart(field: str, filename: str, payload: bytes) -> Tuple[bytes, str]:
    """``(body, content type)`` of a one-file ``multipart/form-data``
    request under a fresh random boundary."""
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="{field}"; filename="{filename}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def detect(
    image_path: str,
    url: str = "http://127.0.0.1:5001/photo",
    client_id: Optional[str] = None,
    save_result_to: Optional[str] = None,
    timeout: float = 600.0,
) -> dict:
    """POST an image to ``url`` and return the parsed JSON answer.  With
    ``save_result_to`` and a ``success`` answer, the base64 result image is
    decoded and written there (`Client.py:56-63`)."""
    with open(image_path, "rb") as f:
        payload = f.read()
    body, ctype = encode_multipart("file", os.path.basename(image_path), payload)
    req = urllib.request.Request(
        url,
        data=body,
        headers={
            "Content-Type": ctype,
            "clientID": client_id or local_client_id(urllib.parse.urlsplit(url).hostname or "127.0.0.1"),
        },
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        data = json.loads(resp.read().decode("utf-8"))
    if save_result_to and data.get("status") == "success" and data.get("data"):
        with open(save_result_to, "wb") as f:
            f.write(base64.b64decode(data["data"]))
    return data


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bdt-client", description="POST an image to bdt-serve (PyTorch port).")
    p.add_argument("image")
    p.add_argument("--url", default="http://127.0.0.1:5001/photo")
    p.add_argument("--save", help="save the returned result image here")
    args = p.parse_args(argv)
    data = detect(args.image, url=args.url, save_result_to=args.save)
    print(json.dumps({k: (v if k != "data" else f"<{len(v or '')} b64 chars>") for k, v in data.items()},
                     ensure_ascii=False))
    return 0 if data.get("status") == "success" else 1


if __name__ == "__main__":
    raise SystemExit(main())
