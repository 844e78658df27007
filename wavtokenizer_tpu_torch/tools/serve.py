"""Codec serving daemon: HTTP front end over the micro-batching engine.

Port of ``tools_tpu/serve.py``: a stdlib ``ThreadingHTTPServer`` takes
concurrent JSON requests and ``api.engine.ServingEngine`` coalesces them into
batched model calls.  No web framework: stdlib ``http.server`` only.

Protocol (JSON bodies; arrays are base64 little-endian with dtype + shape):

  POST /encode     {"audio": <f32 tensor (T,)>}
                   -> {"features": <f32 (D,T')>, "codes": <i32 (T',)>}
  POST /decode     {"features": <f32 (D,T')>}        -> {"audio": <f32 (T,)>}
  POST /detokenize {"codes": <i32 (T',)>}            -> {"audio": <f32 (T,)>}
  GET  /healthz    -> {"ok": true, "device": <card name>}
  GET  /stats      -> batching stats (requests, batches, occupancy)

A malformed payload or an oversized clip is the caller's fault (400); a
closed engine, a device failure or a timeout is ours (500).

Usage:
    python -m wavtokenizer_tpu_torch.tools.serve --port 8787 \\
        [--config c.yaml --checkpoint m.ckpt] [--device cuda] \\
        [--devices cuda:0,cuda:1] [--batch-sizes 1,8,32] [--clip-seconds 3.0] [--warmup]

``--devices`` serves data-parallel: one replica of the weights per listed
device, each bucket batch split over them (every bucket size must divide by
their number); the default is the one ``--device``.

Without --config/--checkpoint it serves the random small-320 model
(``init_wavtokenizer``, seed 0).
"""

from __future__ import annotations

import argparse
import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

REQUEST_TIMEOUT_S = 600


def encode_tensor(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode()}


def decode_tensor(obj: dict) -> np.ndarray:
    arr = np.frombuffer(base64.b64decode(obj["data"]), dtype=obj["dtype"])
    return arr.reshape(obj["shape"]).copy()


def make_handler(engine, device_kind: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "device": device_kind})
            elif self.path == "/stats":
                snap = engine.stats.snapshot()
                snap["mean_batch_occupancy"] = round(snap["mean_batch_occupancy"], 3)
                self._reply(200, snap)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            op = self.path.lstrip("/")
            if op not in ("encode", "decode", "detokenize"):
                self._reply(404, {"error": f"unknown op {op!r}"})
                return
            key = {"encode": "audio", "decode": "features", "detokenize": "codes"}[op]
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                out = engine.submit(op, decode_tensor(req[key])).result(REQUEST_TIMEOUT_S)
                if op == "encode":
                    feats, codes = out
                    self._reply(200, {"features": encode_tensor(feats),
                                      "codes": encode_tensor(codes)})
                else:
                    self._reply(200, {"audio": encode_tensor(out)})
            except (KeyError, TypeError, ValueError) as e:
                # malformed payload or oversized clip (JSONDecodeError is a
                # ValueError): the caller's fault
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # engine closed, device failure, timeout: ours
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 drops or resets connections
    # when a burst of clients connects at once.
    request_queue_size = 256


def build_server(host: str, port: int, engine, device_kind: str) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(engine, device_kind))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices, one replica each (default: --device)")
    ap.add_argument("--batch-sizes", default="1,8,32")
    ap.add_argument("--clip-seconds", default="3.0")
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--warmup", action="store_true",
                    help="run every bucket once before accepting traffic")
    args = ap.parse_args(argv)

    from ..api.engine import EngineConfig, ServingEngine
    from ..api.pretrained import WavTokenizer
    from ..parallel.replicas import device_list

    devices = device_list(args.devices, args.device)
    args.device = devices[0]

    if args.config and args.checkpoint:
        wt = WavTokenizer.from_pretrained0802(args.config, args.checkpoint,
                                              device=args.device)
    else:
        from ..models.init import init_wavtokenizer
        from ..models.wavtokenizer import WavTokenizerSpec
        spec = WavTokenizerSpec()
        wt = WavTokenizer.from_jax_params(init_wavtokenizer(spec, random_codebook=True),
                                          spec, device=args.device)
        print("note: random model (no --config/--checkpoint)", flush=True)

    cfg = EngineConfig(
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")),
        clip_seconds=tuple(float(s) for s in args.clip_seconds.split(",")),
        max_wait_ms=args.max_wait_ms)
    engine = ServingEngine(wt, cfg, devices=devices)
    if args.warmup:
        print("warming up (every bucket once)...", flush=True)
        engine.warmup()
    kind = ", ".join(torch.cuda.get_device_name(d) if d.type == "cuda" else str(d)
                     for d in devices)
    httpd = build_server(args.host, args.port, engine, kind)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} (device: {kind})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
