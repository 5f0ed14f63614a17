"""The port's HTTP server (gtax_torch.cli.serve) against gtax's
(gtax.cli.serve): gtax's tests/test_serve_http.py cases on the port's
server, and the same requests to both servers, which must give the same
status codes and /healthz keys. Each runs the real ThreadingHTTPServer on
an ephemeral port in a thread with DiT-debug / vae-debug and random
weights, in fp32 on the CPU, driven through urllib.

One difference is by design and pinned here: a seed past 64 bits, which
gtax accepts and then fails inside the generation (500), is a bad request
for the port (400)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ARGS = ["--port", "0", "--dit_model_path", "", "--vae_model_path", "",
        "--dit_model", "DiT-debug", "--vae_model", "vae-debug",
        "--dtype", "float32", "--attention_backend", "xla",
        "--quantize", "none", "--noise_steps", "2", "--max_frames", "8"]


def _serve(make_server, args):
    server = make_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    from gtax.cli import serve as jserve
    from gtax_torch.cli import serve as tserve

    port = _serve(tserve.make_server,
                  tserve.build_parser().parse_args(ARGS + ["--device",
                                                           "cpu"]))
    ref = _serve(jserve.make_server, jserve.build_parser().parse_args(ARGS))
    yield {"port": port[1], "gtax": ref[1], "server": port[0]}
    for s, _ in (port, ref):
        s.shutdown()


def _b64_png(h=48, w=64, seed=0):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, obj, path="/generate"):
    req = urllib.request.Request(
        url + path, json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _status(call):
    """(status code, headers, body) of a request, errors included."""
    try:
        with call() as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_healthz(servers):
    with urllib.request.urlopen(servers["port"] + "/healthz",
                                timeout=30) as r:
        body = json.load(r)
    assert body["ok"] and body["model"] == "DiT-debug"
    assert body["config"] == {"quantize": "none", "noise_steps": 2,
                              "backend": "xla", "dtype": "float32"}


def test_generate_returns_mp4(servers):
    with _post(servers["port"], {"image": _b64_png(), "num_frames": 4,
                                 "seed": 7}) as r:
        assert r.headers["Content-Type"] == "video/mp4"
        assert r.headers["X-Seed"] == "7"
        assert r.headers["Content-Disposition"] == (
            'attachment; filename="video.mp4"')
        data = r.read()
    assert len(data) > 0 and data[4:8] == b"ftyp"  # mp4 container magic


def test_generate_is_the_generator_s_video(servers):
    """The mp4 is what the handler's path gives for the decoded frame and
    seed: parse_request, generate_pixels on the server's generator, then
    mp4_bytes (the same bytes)."""
    from gtax_torch.cli import serve as tserve

    body = json.dumps({"image": _b64_png(seed=3), "num_frames": 3,
                       "seed": 11}).encode()
    frame, actions, n, seed = tserve.parse_request(body, (48, 64), 8)
    s = servers["server"]
    pixels = tserve.generate_pixels(s.generator, s.lock, frame, actions, n,
                                    seed)
    assert pixels.shape == (3, 48, 64, 3) and pixels.dtype == np.uint8
    with _post(servers["port"], json.loads(body)) as r:
        assert r.read() == tserve.mp4_bytes(pixels)


def test_generate_validates(servers):
    url = servers["port"]
    for body in ({"image": _b64_png(), "num_frames": 999},
                 {"num_frames": 4},
                 {"image": _b64_png(), "num_frames": 4,
                  "actions": [[0.0] * 25] * 2},
                 {"image": _b64_png(), "num_frames": 4, "seed": "abc"},
                 {"image": _b64_png(), "num_frames": 4, "seed": 2**64}):
        code, headers, data = _status(lambda: _post(url, body))
        assert code == 400 and "bad request" in json.loads(data)["error"]
    code, _, data = _status(lambda: urllib.request.urlopen(url + "/nope",
                                                           timeout=30))
    assert code == 404 and json.loads(data) == {"error": "unknown path"}


REQUESTS = {
    "healthz": ("GET", "/healthz", None),
    "get_unknown": ("GET", "/nope", None),
    "post_unknown": ("POST", "/nope", {"num_frames": 4}),
    "ok": ("POST", "/generate", {"num_frames": 3, "seed": 1}),
    "ok_actions": ("POST", "/generate",
                   {"num_frames": 3, "actions": [[0.0] * 25] * 3}),
    "too_many_frames": ("POST", "/generate", {"num_frames": 999}),
    "one_frame": ("POST", "/generate", {"num_frames": 1}),
    "no_image": ("POST", "/generate", {"num_frames": 4, "image": None}),
    "not_an_image": ("POST", "/generate",
                     {"num_frames": 4,
                      "image": base64.b64encode(b"abc").decode()}),
    "short_actions": ("POST", "/generate",
                      {"num_frames": 4, "actions": [[0.0] * 25] * 2}),
    "bad_action_width": ("POST", "/generate",
                         {"num_frames": 3, "actions": [[0.0] * 24] * 3}),
    "bad_seed": ("POST", "/generate", {"num_frames": 4, "seed": "abc"}),
    "not_json": ("POST", "/generate", b"{nope"),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_same_answers_as_gtax(servers, name):
    """Both servers answer the request with the same status code; JSON
    answers have the same keys (and /healthz the same config keys)."""
    method, path, body = REQUESTS[name]
    answers = []
    for url in (servers["port"], servers["gtax"]):
        if method == "GET":
            answers.append(_status(lambda: urllib.request.urlopen(
                url + path, timeout=30)))
            continue
        if isinstance(body, dict):
            obj = dict(body)
            if "image" not in obj:
                obj["image"] = _b64_png()
            elif obj["image"] is None:
                del obj["image"]
            data = json.dumps(obj).encode()
        else:
            data = body
        req = urllib.request.Request(url + path, data, method="POST")
        answers.append(_status(lambda: urllib.request.urlopen(
            req, timeout=300)))
    (code, headers, data), (jcode, jheaders, jdata) = answers
    assert code == jcode, (code, jcode, data[:200], jdata[:200])
    assert headers["Content-Type"] == jheaders["Content-Type"]
    if headers["Content-Type"] == "application/json":
        got, want = json.loads(data), json.loads(jdata)
        assert got.keys() == want.keys()
        if "config" in want:
            assert got["config"].keys() == want["config"].keys()
            assert got == want
    else:
        assert headers.keys() >= {"X-Seed", "Content-Disposition"}
        if "seed" in body:  # else each server draws its own
            assert headers["X-Seed"] == jheaders["X-Seed"]


def test_seed_past_64_bits(servers):
    """The one difference by design: gtax accepts the seed and fails inside
    the generation (500); the port refuses it as a bad request (400)."""
    body = {"image": _b64_png(), "num_frames": 3, "seed": 2**64}
    assert _status(lambda: _post(servers["gtax"], body))[0] == 500
    assert _status(lambda: _post(servers["port"], body))[0] == 400


def test_default_path_serves():
    """The defaults (int8 W8A8 on the fused backend) build and answer, on
    the CPU's plain versions."""
    from gtax_torch.cli import serve as tserve

    args = tserve.build_parser().parse_args([
        "--port", "0", "--dit_model_path", "", "--vae_model_path", "",
        "--dit_model", "DiT-debug", "--vae_model", "vae-debug",
        "--dtype", "float32", "--noise_steps", "2", "--device", "cpu"])
    assert (args.quantize, args.attention_backend, args.max_frames) == (
        "int8", "fused", 128)
    server, url = _serve(tserve.make_server, args)
    try:
        with _post(url, {"image": _b64_png(), "num_frames": 3,
                         "seed": 2}) as r:
            assert r.status == 200 and r.read()[4:8] == b"ftyp"
        assert "kernel_q" in server.generator.dit_params["blocks"][0][
            "s_attn"]["qkv"]
    finally:
        server.shutdown()
