"""HTTP serving front end for the PyTorch inference engine.

The port of the JAX package's ``serve.py``: a stdlib ``ThreadingHTTPServer``
whose request threads hand their rows to a micro-batcher. Concurrent requests
that arrive within ``batch_window_ms`` are coalesced into one engine call, and
one batcher thread per tower owns all device dispatch (the kernels launch on
that thread's current CUDA stream).

    GET  /health                                   liveness + engine config
    POST /v1/encode_text   {"texts": [...]}        -> {"features": ...}
    POST /v1/encode_image  {"images_b64": [...]}   -> {"features": ...}
    POST /v1/similarity    {"texts": [...], "images_b64": [...]} -> {"logits": ...}
    POST /v1/caption       CoCa only (not ported yet): answers 400

CLI: ``python -m refining_clip_via_dinov2_representations_torch.serve
--model ViT-B-16 [--checkpoint state_dict.pt] [--device cuda] --port 8080``.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np


class _Batcher:
    """Coalesce concurrent request arrays into single engine calls.

    A dedicated thread waits for the first item, then keeps collecting until
    ``max_rows`` rows are pending or ``window_ms`` has passed since the first
    item; it concatenates, runs ``fn`` once and splits the result back per
    request. An exception reaches every waiting request of the failed batch.
    """

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], max_rows: int,
                 window_ms: float = 5.0):
        self._fn = fn
        self._max_rows = int(max_rows)
        self._window_s = window_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        """Blocking: returns this request's rows of the coalesced result."""
        done = threading.Event()
        slot: dict = {}
        self._q.put((x, done, slot))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def close(self) -> None:
        self._stop = True
        self._q.put(None)  # wake the drain loop
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop:
            item = self._q.get()
            if item is None:
                continue
            batch = [item]
            rows = item[0].shape[0]
            deadline = time.monotonic() + self._window_s
            while rows < self._max_rows:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    continue
                batch.append(nxt)
                rows += nxt[0].shape[0]
            try:
                out = self._fn(np.concatenate([b[0] for b in batch], axis=0))
                ofs = 0
                for x, done, slot in batch:
                    slot["out"] = out[ofs: ofs + x.shape[0]]
                    ofs += x.shape[0]
                    done.set()
            except Exception as e:  # propagate to every waiter, keep serving
                for _, done, slot in batch:
                    slot["err"] = e
                    done.set()


class ClipServer:
    """The serving bundle: engine + preprocess + tokenizer + two batchers."""

    def __init__(self, engine, preprocess, tokenizer, batch_window_ms: float = 5.0):
        self.engine = engine
        self.preprocess = preprocess
        self.tokenizer = tokenizer
        top = engine.buckets[-1]
        self._text_batcher = _Batcher(engine.encode_text, top, batch_window_ms)
        self._image_batcher = _Batcher(engine.encode_image, top, batch_window_ms)

    def health(self) -> dict:
        return {
            "status": "ok",
            "buckets": list(self.engine.buckets),
            "image_size": list(self.engine.image_size),
            "context_length": self.engine.context_length,
            "quantize": None,
            "mesh": None,
            "device": str(self.engine.device),
        }

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            raise ValueError("'texts' must be a non-empty list of strings")
        ids = np.asarray(self.tokenizer(list(texts)), np.int32)
        return self._text_batcher.submit(ids)

    def _decode_images(self, images_b64: Sequence[str]) -> np.ndarray:
        if not images_b64:
            raise ValueError("'images_b64' must be a non-empty list")
        from PIL import Image

        pixels = []
        for s in images_b64:
            with Image.open(io.BytesIO(base64.b64decode(s))) as img:
                pixels.append(np.asarray(self.preprocess(img.convert("RGB"))))
        return np.stack(pixels).astype(np.float32)

    def encode_image_b64(self, images_b64: Sequence[str]) -> np.ndarray:
        return self._image_batcher.submit(self._decode_images(images_b64))

    def similarity(self, texts: Sequence[str], images_b64: Sequence[str]) -> np.ndarray:
        img_f = self.encode_image_b64(images_b64)
        txt_f = self.encode_text(texts)
        scale, bias = self.engine.logit_terms()
        return scale * (img_f @ txt_f.T) + bias

    def caption(self, images_b64: Sequence[str]) -> List[str]:
        """CoCa captioning. No CoCa model is ported, so the engine raises
        TypeError, which the client sees as a 400."""
        pixels = self._decode_images(images_b64)
        try:
            tokens = self.engine.caption_tokens(pixels)
        except TypeError as e:  # non-CoCa engine -> client error, not a 500
            raise ValueError(str(e)) from e
        return [self.tokenizer.decode(row).strip() for row in np.asarray(tokens)]

    def close(self) -> None:
        self._text_batcher.close()
        self._image_batcher.close()


def _make_handler(server: ClipServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logging.debug("serve: " + fmt, *args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, server.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/encode_text":
                    out = server.encode_text(req.get("texts", []))
                    self._reply(200, {"features": out.tolist()})
                elif self.path == "/v1/encode_image":
                    out = server.encode_image_b64(req.get("images_b64", []))
                    self._reply(200, {"features": out.tolist()})
                elif self.path == "/v1/similarity":
                    out = server.similarity(req.get("texts", []), req.get("images_b64", []))
                    self._reply(200, {"logits": out.tolist()})
                elif self.path == "/v1/caption":
                    self._reply(200, {"captions": server.caption(req.get("images_b64", []))})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # engine/device failure: 500, keep alive
                logging.exception("serve: request failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_http_server(server: ClipServer, host: str = "0.0.0.0",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); call ``.serve_forever()`` to run."""
    cls = type("ClipHTTPServer", (ThreadingHTTPServer,),
               # a burst of concurrent clients must queue, not be refused
               {"request_queue_size": 128})
    return cls((host, port), _make_handler(server))


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="CLIP serving front end (PyTorch/CUDA)")
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="open_clip-layout state dict (torch.save); random init without")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--buckets", type=int, nargs="+", default=None)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    args = p.parse_args(argv)

    from .inference import DEFAULT_BUCKETS, create_engine

    engine, preprocess, tokenizer = create_engine(
        args.model, checkpoint=args.checkpoint, device=args.device,
        buckets=tuple(args.buckets) if args.buckets else DEFAULT_BUCKETS,
    )
    server = ClipServer(engine, preprocess, tokenizer, batch_window_ms=args.batch_window_ms)
    httpd = make_http_server(server, args.host, args.port)
    logging.basicConfig(level=logging.INFO)
    logging.info("serving %s on %s:%d (%s, buckets %s)", args.model, args.host,
                 httpd.server_address[1], engine.device, engine.buckets)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
