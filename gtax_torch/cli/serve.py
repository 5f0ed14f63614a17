"""Minimal HTTP inference server over the serving API (counterpart of
gtax/cli/serve.py: the same flags, defaults, endpoints, status codes and
headers, plus --device).

One process owns the card; requests are serialised through one lock
around it. Scale out with more processes behind a load balancer, one a
card. Stdlib only: nothing between the socket and VideoGenerator.

Endpoints:
  GET  /healthz       -> {"ok": true, "model": ..., "config": {...}}
  POST /generate      JSON body:
        {"image": <base64 png/jpg>,        # the start frame (required)
         "num_frames": 32,                 # prompt + generated
         "seed": 0,                        # optional; random if absent
         "actions": [[...25 floats]...]}   # optional, per frame
      -> video/mp4 bytes (Content-Disposition: attachment, X-Seed)
  A request that does not parse (no image, an image that does not decode,
  num_frames out of range, short actions, a seed that is not a 64-bit
  signed integer) gets 400, a failed generation or mp4 write 500, an
  unknown path 404, each with a JSON {"error": ...}. (gtax answers a seed
  past 64 bits with 500 from inside the generation: not replicated.)

The default serves int8 (W8A8) on the fused kernels, on the card:

  python -m gtax_torch.cli.serve --port 8000 \\
      --dit_model_path dit.safetensors --vae_model_path vit-l-20.safetensors

Empty model paths give random weights; --device cpu runs the plain
versions (with --dtype float32).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
import threading

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="gtax_torch HTTP inference "
                                            "server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dit_model_path", default="checkpoints/dit.safetensors")
    p.add_argument("--vae_model_path",
                   default="checkpoints/vit-l-20.safetensors")
    p.add_argument("--dtype", default="bfloat16",
                   help="float32: the kernels' fp32 forms on the card, "
                        "int8 (the default --quantize) included")
    p.add_argument("--attention_backend", default="fused")
    p.add_argument("--quantize", choices=["none", "int8"], default="int8")
    p.add_argument("--noise_steps", type=int, default=100)
    p.add_argument("--max_frames", type=int, default=128,
                   help="reject requests beyond this num_frames")
    p.add_argument("--dit_model", default="DiT-S/2")
    p.add_argument("--vae_model", default="vit-l-20-shallow-encoder")
    p.add_argument("--aot_dir", default=None,
                   help="AOT kernel-library cache dir (gtax_torch.aot): a "
                        "restarted server loads the library instead of "
                        "building it")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def parse_request(body: bytes, size_hw, max_frames: int):
    """(frame (3, H, W) float32, actions (1, n, 25) or None, num_frames,
    seed) of a /generate body; anything wrong raises (a 400)."""
    from gtax_torch.io.video import read_image_bytes

    req = json.loads(body)
    num_frames = int(req.get("num_frames", 32))
    if not 1 < num_frames <= max_frames:
        raise ValueError(f"num_frames must be in (1, {max_frames}]")
    frame = read_image_bytes(base64.b64decode(req["image"]), size_hw)
    actions = req.get("actions")
    if actions is not None:
        actions = np.asarray(actions, np.float32)[None]
        if (actions.ndim != 3 or actions.shape[-1] != 25
                or actions.shape[1] < num_frames):
            raise ValueError(f"actions must be ({num_frames}+, 25), got "
                             f"{actions.shape[1:]}")
    seed = int(req["seed"]) if "seed" in req else (
        int.from_bytes(os.urandom(4), "big"))
    if not -2**63 <= seed < 2**63:  # gtax answered these 500 (ROADMAP C)
        raise ValueError(f"seed must be a 64-bit signed integer, got {seed}")
    return frame, actions, num_frames, seed


def generate_pixels(gen, lock, frame, actions, num_frames: int, seed: int):
    """The request's (num_frames, H, W, 3) uint8 video from one decoded
    start frame, under the card's lock."""
    with lock:
        return gen.generate(frame[None, None], actions,
                            num_frames=num_frames, seed=seed)[0]


def mp4_bytes(pixels) -> bytes:
    """The video as mp4 bytes (written through a file, as the writers need
    a path)."""
    from gtax_torch.io.video import write_video

    with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
        write_video(f.name, pixels, fps=10)
        with open(f.name, "rb") as fh:
            return fh.read()


def make_server(args):
    """Build (and return) the configured ThreadingHTTPServer, apart from
    main() so that tests run it on port 0 in a thread. The server carries
    its generator and lock (`server.generator`, `server.lock`)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from gtax_torch.serving import ServingConfig, VideoGenerator

    cfg = ServingConfig(
        dtype=args.dtype, attention_backend=args.attention_backend,
        quantize=args.quantize, noise_steps=args.noise_steps,
        aot_dir=args.aot_dir, dit_model=args.dit_model,
        vae_model=args.vae_model)
    gen = VideoGenerator.load(args.dit_model_path, args.vae_model_path, cfg,
                              device=args.device)
    lock = threading.Lock()  # the card runs one rollout at a time
    size_hw = (gen.vae_cfg.input_height, gen.vae_cfg.input_width)

    class Handler(BaseHTTPRequestHandler):
        # a client that stalls mid-body must not pin a handler thread
        # forever (rfile.read blocks on Content-Length)
        timeout = 120

        def log_message(self, fmt, *a):  # through print, not stderr
            print("[gtax_torch.serve]", fmt % a)

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, {
                "ok": True, "model": cfg.dit_model,
                "config": {"quantize": cfg.quantize,
                           "noise_steps": cfg.noise_steps,
                           "backend": cfg.attention_backend,
                           "dtype": cfg.dtype}})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                frame, actions, num_frames, seed = parse_request(
                    self.rfile.read(n), size_hw, args.max_frames)
            except Exception as e:
                return self._json(400, {"error": f"bad request: {e}"})
            try:
                data = mp4_bytes(generate_pixels(gen, lock, frame, actions,
                                                 num_frames, seed))
            except Exception as e:
                return self._json(500, {"error": f"generation failed: {e}"})
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Disposition",
                             'attachment; filename="video.mp4"')
            self.send_header("X-Seed", str(seed))
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.generator, server.lock = gen, lock
    return server


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = make_server(args)
    print(f"[gtax_torch.serve] listening on http://{args.host}:"
          f"{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
