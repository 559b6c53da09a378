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
    POST /v1/caption       {"images_b64": [...], "seq_len"?, "num_beams"?,
                           "num_beam_groups"?, "min_seq_len"?,
                           "repetition_penalty"?, "length_penalty"?}
                           -> {"captions": [...]} (CoCa models: grouped beam
                           search, BPE decode; 400 on another model)

CLI: ``python -m refining_clip_via_dinov2_representations_torch.serve
--model ViT-B-16 [--pretrained openai] [--checkpoint state_dict.pt]
[--quantize int8] [--device cuda] --port 8080``, the JAX server's flags
(``tpu/serve.py:291-300``): ``--pretrained`` is a tag resolved from the hub
cache, ``--checkpoint`` a state-dict file loaded over it (a CoCa
captioner: ``--model coca_ViT-L-14 --pretrained
mscoco_finetuned_laion2b_s13b_b90k``); ``--quantize int8`` serves
weight-only int8 (``inference.py``). A model split over the model axis runs
one process a card under torchrun::

    torchrun --nproc-per-node 2 -m refining_clip_via_dinov2_representations_torch.serve \
        --model ViT-B-16 --pretrained openai --mesh-model-axis 2

Every rank joins the process group (``train/distributed.py:
init_distributed_device``: NCCL on cards, gloo with ``--device cpu``) and
builds the engine on its part of the ``(data, model)`` mesh; rank 0 alone binds the port and runs the
micro-batchers, and sends each engine call to the others, which wait in
``ClipInferenceEngine.follow``. Shutting rank 0 down stops them; a failed
call on the mesh ends the server with an error.
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

# the caption request's generation parameters
GEN_PARAMS = ("seq_len", "num_beams", "num_beam_groups", "min_seq_len", "repetition_penalty",
              "length_penalty")


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
            "quantize": self.engine.quantize,
            "mesh": None if self.engine.mesh is None
            else dict(zip(self.engine.mesh.mesh_dim_names, self.engine.mesh.shape)),
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

    def caption(self, images_b64: Sequence[str], **gen_kwargs) -> List[str]:
        """Caption images with a CoCa engine (grouped beam search). The
        parameters vary per request, so captioning bypasses the
        micro-batchers; the engine's buckets still pad the request's rows.
        Each caption is its tokens after SOT and before the first EOT, BPE
        decoded. A non-CoCa engine raises TypeError, which the client sees
        as a 400, as do bad parameters (``_validate_gen_kwargs``)."""
        gen_kwargs = self._validate_gen_kwargs(gen_kwargs)
        pixels = self._decode_images(images_b64)
        try:
            tokens = self.engine.caption_tokens(pixels, **gen_kwargs)
        except TypeError as e:  # non-CoCa engine -> client error, not a 500
            raise ValueError(str(e)) from e
        sot, eot = 49406, 49407
        out = []
        for row in np.asarray(tokens).tolist():
            body = row[1:] if row and row[0] == sot else row
            if eot in body:
                body = body[:body.index(eot)]
            out.append(self.tokenizer.decode(body).strip())
        return out

    def _validate_gen_kwargs(self, gen: dict) -> dict:
        """The JAX server's checks: ints coerced and bounded, the penalties
        in [0.01, 100] rounded to 3 decimals, unknown names refused (each a
        ValueError, so a 400)."""
        out = {}
        ints = {"seq_len": (2, min(77, self.engine.context_length)),
                "num_beams": (2, 16), "num_beam_groups": (1, 16), "min_seq_len": (1, 76)}
        for k, (lo, hi) in ints.items():
            if k in gen:
                v = int(gen[k])
                if not lo <= v <= hi:
                    raise ValueError(f"{k} must be in [{lo}, {hi}], got {v}")
                out[k] = v
        for k in ("repetition_penalty", "length_penalty"):
            if k in gen:
                v = float(gen[k])
                if not 0.01 <= v <= 100.0:
                    raise ValueError(f"{k} must be in [0.01, 100], got {v}")
                out[k] = round(v, 3)
        unknown = set(gen) - set(ints) - {"repetition_penalty", "length_penalty"}
        if unknown:
            raise ValueError(f"unknown caption parameters: {sorted(unknown)}")
        return out

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
                    gen = {k: req[k] for k in GEN_PARAMS if k in req}
                    self._reply(200, {"captions": server.caption(req.get("images_b64", []),
                                                                 **gen)})
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CLIP serving front end (PyTorch/CUDA)")
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", default=None,
                   help="a pretrained tag of the model, resolved from the hub cache")
    p.add_argument("--checkpoint", default=None,
                   help="an open_clip-layout state-dict file, loaded over --pretrained; "
                        "random init without either")
    p.add_argument("--cache-dir", default=None, help="the hub cache of the tags")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--buckets", type=int, nargs="+", default=None)
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--mesh-model-axis", type=int, default=1,
                   help="split the model over this many ranks (torchrun, one process a card)")
    return p


def _mesh(args):
    """(mesh, device) of a ``--mesh-model-axis`` launch: the process group
    joined, the ``(data, model)`` mesh built."""
    from types import SimpleNamespace

    from .parallel.mesh import create_mesh, log_mesh
    from .train.distributed import init_distributed_device, is_using_distributed

    if not is_using_distributed():
        raise ValueError(f"--mesh-model-axis {args.mesh_model_axis} needs a process group: "
                         "launch with torchrun (one process a card)")
    ns = SimpleNamespace(device=args.device, force_cpu=False, dist_url=None,
                         dist_backend=None, no_set_device_rank=False)
    device = init_distributed_device(ns)
    mesh = create_mesh(model=args.mesh_model_axis, device_type=device.type)
    log_mesh(mesh)
    return mesh, device


def main(argv: Optional[List[str]] = None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None) -> None:
    """Serve until interrupted (or ``httpd.shutdown()``). ``on_ready(httpd)``
    is called on the serving rank once it listens, from a thread of its own
    (to drive the server from the same process)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mesh, device = None, args.device
    if args.mesh_model_axis > 1:
        mesh, device = _mesh(args)

    from .inference import DEFAULT_BUCKETS, create_engine

    engine, preprocess, tokenizer = create_engine(
        args.model, pretrained=args.pretrained, checkpoint=args.checkpoint, device=device,
        buckets=tuple(args.buckets) if args.buckets else DEFAULT_BUCKETS,
        quantize=args.quantize, mesh=mesh, cache_dir=args.cache_dir,
    )
    if not engine.leader:
        engine.follow()  # until rank 0 stops; raises where a call fails
        return
    server = ClipServer(engine, preprocess, tokenizer, batch_window_ms=args.batch_window_ms)
    httpd = make_http_server(server, args.host, args.port)
    logging.info("serving %s on %s:%d (%s, buckets %s, quantize %s, mesh %s)", args.model,
                 args.host, httpd.server_address[1], engine.device, engine.buckets,
                 engine.quantize, server.health()["mesh"])
    # a failed call on the mesh leaves the ranks out of step: end the server
    threading.Thread(target=lambda: engine.broken.wait() and httpd.shutdown(),
                     daemon=True).start()
    if on_ready is not None:
        threading.Thread(target=on_ready, args=(httpd,), daemon=True).start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
        engine.stop()
    if engine.broken.is_set():
        raise RuntimeError("a call failed on the mesh; the server stopped")


if __name__ == "__main__":
    main()
