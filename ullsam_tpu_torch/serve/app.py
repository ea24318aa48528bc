"""uLLSAM serving app on the port: interactive segmentation and captioning
over HTTP (``ullsam_tpu/serve/app.py``).

A stdlib server with a JSON API and a minimal browser UI, in place of the
reference's Gradio app (app.py, port 9996): click-to-segment with the LLM
dense prompt, instance accumulation, uint16 TIFF export, and captions
through the continuous-batching engine (``serve/engine.py``) or, without
it, through ``chat`` / ``stream_chat``. The model runs on the card unless
``--device cpu``.

Run (a tokenizer asset directory holding ``tokenizer.model``):
  python -m ullsam_tpu_torch.serve.app --engine [--quant int8] \
      --tokenizer_path DIR [--checkpoint ckpt.pt]
  python -m ullsam_tpu_torch.serve.app --tiny --smoke --engine \
      --tokenizer_path DIR --port 0    # self-test on a tiny model
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

_HTML = """<!doctype html>
<html><head><title>uLLSAM-TPU</title><style>
body{font-family:sans-serif;margin:20px;background:#111;color:#eee}
canvas{border:1px solid #555;cursor:crosshair}
button{margin:4px;padding:6px 12px}  textarea{width:640px}
#caption{white-space:pre-wrap;max-width:640px}
</style></head><body>
<h2>uLLSAM-TPU — interactive microscopy segmentation</h2>
<input type=file id=file accept="image/*"> point type:
<select id=label><option value=1>positive</option><option value=0>negative</option></select>
<button onclick=genMask()>Generate mask</button>
<button onclick=saveInst()>Save instance</button>
<button onclick=clearPts()>Clear points</button>
<button onclick=resetAll()>Reset instances</button>
<a href="/api/export?session=ui" download="instances.tiff"><button>Export TIFF</button></a>
<button onclick=caption()>Caption</button>
<div id=status></div>
<canvas id=cv width=640 height=640></canvas>
<div id=caption></div>
<script>
let pts=[], img=new Image();
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
document.getElementById('file').onchange=async e=>{
  const f=e.target.files[0]; const b=await f.arrayBuffer();
  const b64=btoa(String.fromCharCode(...new Uint8Array(b)));
  await api('/api/image',{image_b64:b64}); pts=[]; await refresh();};
cv.onclick=async e=>{
  const r=cv.getBoundingClientRect();
  const x=(e.clientX-r.left)/cv.width*1024, y=(e.clientY-r.top)/cv.height*1024;
  await api('/api/click',{x:x,y:y,label:+document.getElementById('label').value});
  pts.push([e.clientX-r.left,e.clientY-r.top]); draw();};
async function api(p,body){const r=await fetch(p,{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(Object.assign({session:'ui'},body||{}))});return r.json();}
async function refresh(){const r=await api('/api/view');if(r.view_png_b64){img.src='data:image/png;base64,'+r.view_png_b64;img.onload=draw;}if(r.iou!==undefined)document.getElementById('status').innerText='IoU pred: '+r.iou.toFixed(3);}
function draw(){ctx.drawImage(img,0,0,cv.width,cv.height);ctx.fillStyle='yellow';for(const p of pts)ctx.fillRect(p[0]-3,p[1]-3,6,6);}
async function genMask(){document.getElementById('status').innerText='segmenting...';await api('/api/mask');pts=[];await refresh();}
async function saveInst(){await api('/api/save_instance');pts=[];await refresh();}
async function clearPts(){await api('/api/clear_points');pts=[];await refresh();}
async function resetAll(){await api('/api/reset');pts=[];await refresh();}
async function caption(){const cap=document.getElementById('caption');const st=document.getElementById('status');st.innerText='captioning...';cap.innerText='';
 const resp=await fetch('/api/caption_stream',{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify({session:'ui',question:'Describe the image in detail.'})});
 const rd=resp.body.getReader();const dec=new TextDecoder();let buf='';
 for(;;){const {done,value}=await rd.read();if(done)break;buf+=dec.decode(value,{stream:true});
  for(let i;(i=buf.indexOf('\n\n'))>=0;){const ev=buf.slice(0,i);buf=buf.slice(i+2);
   if(!ev.startsWith('data: '))continue;const d=ev.slice(6);if(d=='[DONE]')continue;
   const o=JSON.parse(d);if(o.delta)cap.innerText+=o.delta;if(o.error)cap.innerText+=' [error: '+o.error+']';}}
 st.innerText='';}
</script></body></html>"""


class AppServer:
    """Holds the model and the sessions; request handling is thin JSON
    glue."""

    def __init__(self, model, cfg, tokenizer, engine=None):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.engine = engine
        self.sessions: Dict[str, "object"] = {}
        self.lock = threading.Lock()
        self.mode = "v1"  # v1 = LLM-guided dense prompt; baseline = vanilla

    def session(self, name: str):
        from ullsam_tpu_torch.serve.state import Session

        with self.lock:
            if name not in self.sessions:
                self.sessions[name] = Session()
            return self.sessions[name]

    # -- operations -------------------------------------------------------

    def set_image(self, sess, image: np.ndarray):
        sess.set_image(image, target=self.cfg.sam.vit.img_size)

    def ensure_prompt(self, sess):
        """One fused forward per image (cached; the reference reruns the
        LLM on every click, app.py:580-598)."""
        if sess.sam_features is not None:
            return
        from ullsam_tpu_torch.models.ullsam.chat import segment_forward

        t0 = time.time()
        dense, feats = segment_forward(self.model, self.cfg, self.tokenizer,
                                       sess.model_input)
        sess.dense_prompt = dense if self.mode == "v1" else None
        sess.sam_features = feats
        sess.t_mllm = time.time() - t0

    def generate_mask(self, sess):
        from ullsam_tpu_torch.models.ullsam.chat import point_segment

        if not sess.points:
            raise ValueError("no points clicked")
        self.ensure_prompt(sess)
        t0 = time.time()
        mask, _, iou = point_segment(
            self.model, self.cfg, sess.sam_features, sess.dense_prompt,
            np.asarray([sess.points], np.float32),
            np.asarray([sess.labels], np.int64))
        sess.current_mask = mask[0, 0].cpu().numpy()
        sess.current_iou = float(iou[0, 0])
        sess.t_sam = time.time() - t0
        return sess.current_iou

    def caption(self, sess, question: str, max_new_tokens: int = 256,
                **sampling) -> str:
        """sampling: temperature / top_p / top_k / do_sample per request,
        the reference's caption generation_config (app.py:443-459)."""
        if self.engine is not None:
            # uint8 (display is model_input * 255 exactly); the engine
            # converts on the device
            return self.engine.caption(sess.display[None], question,
                                       max_new_tokens=max_new_tokens,
                                       **sampling)
        from ullsam_tpu_torch.models.internlm2.generate import (
            GenerationConfig)
        from ullsam_tpu_torch.models.ullsam.chat import chat

        overrides = {k: v for k, v in sampling.items() if v is not None}
        return chat(self.model, self.cfg, self.tokenizer, sess.model_input,
                    question, gen=GenerationConfig(
                        max_new_tokens=max_new_tokens, **overrides))

    def caption_stream(self, sess, question: str, max_new_tokens: int = 256,
                       **sampling):
        """Generator of caption text deltas, the streaming analog of
        ``caption`` (reference stream_chat, modeling_internlm2.py:1230-1292,
        exposed here as server-sent events)."""
        if self.engine is not None:
            yield from self.engine.stream_caption(
                sess.display[None], question,
                max_new_tokens=max_new_tokens, **sampling)
            return
        from ullsam_tpu_torch.models.internlm2.generate import (
            GenerationConfig)
        from ullsam_tpu_torch.models.ullsam.chat import stream_chat

        overrides = {k: v for k, v in sampling.items() if v is not None}
        yield from stream_chat(self.model, self.cfg, self.tokenizer,
                               sess.model_input, question,
                               gen=GenerationConfig(
                                   max_new_tokens=max_new_tokens,
                                   **overrides))

    def view_png(self, sess) -> bytes:
        from PIL import Image

        from ullsam_tpu_torch.serve.state import instance_overlay

        img = instance_overlay(sess.display, sess.instances,
                               sess.current_mask)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()


def make_handler(app: AppServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                body = _HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/api/export"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                sess = app.session(q.get("session", ["ui"])[0])
                try:
                    data = sess.export_tiff()
                except Exception as e:
                    return self._json({"error": str(e)}, 400)
                self.send_response(200)
                self.send_header("Content-Type", "image/tiff")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/api/health":
                self._json({"ok": True, "mode": app.mode})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            sess = app.session(req.get("session", "ui"))
            try:
                if self.path == "/api/image":
                    from PIL import Image
                    raw = base64.b64decode(req["image_b64"])
                    img = np.asarray(Image.open(io.BytesIO(raw)))
                    app.set_image(sess, img)
                    self._json({"ok": True,
                                "orig_hw": list(sess.geometry["orig_hw"])})
                elif self.path == "/api/click":
                    sess.add_point(req["x"], req["y"], req.get("label", 1))
                    self._json({"ok": True, "n_points": len(sess.points)})
                elif self.path == "/api/mask":
                    iou = app.generate_mask(sess)
                    self._json({"ok": True, "iou": iou,
                                "t_mllm": getattr(sess, "t_mllm", None),
                                "t_sam": getattr(sess, "t_sam", None)})
                elif self.path == "/api/save_instance":
                    inst = sess.save_instance()
                    self._json({"ok": True, "instance_id": inst})
                elif self.path == "/api/clear_points":
                    sess.clear_points()
                    self._json({"ok": True})
                elif self.path == "/api/reset":
                    sess.reset_instances()
                    self._json({"ok": True})
                elif self.path == "/api/caption":
                    sampling = {
                        k: cast(req[k]) for k, cast in
                        [("temperature", float), ("top_p", float),
                         ("top_k", int), ("do_sample", bool)] if k in req}
                    text = app.caption(sess,
                                       req.get("question",
                                               "Describe the image in "
                                               "detail."),
                                       int(req.get("max_new_tokens", 256)),
                                       **sampling)
                    self._json({"ok": True, "caption": text})
                elif self.path == "/api/caption_stream":
                    # Server-Sent Events: one `data: {json}` event per text
                    # delta, then `data: [DONE]`.
                    sampling = {
                        k: cast(req[k]) for k, cast in
                        [("temperature", float), ("top_p", float),
                         ("top_k", int), ("do_sample", bool)] if k in req}
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        for delta in app.caption_stream(
                                sess,
                                req.get("question",
                                        "Describe the image in detail."),
                                int(req.get("max_new_tokens", 256)),
                                **sampling):
                            payload = json.dumps({"delta": delta})
                            self.wfile.write(
                                f"data: {payload}\n\n".encode())
                            self.wfile.flush()
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                    except BrokenPipeError:
                        pass  # client hung up mid-stream
                    except Exception as e:  # headers already sent
                        err = json.dumps(
                            {"error": f"{type(e).__name__}: {e}"})
                        self.wfile.write(f"data: {err}\n\n".encode())
                        self.wfile.flush()
                elif self.path == "/api/view":
                    png = app.view_png(sess)
                    self._json({"ok": True, "iou": sess.current_iou,
                                "view_png_b64":
                                base64.b64encode(png).decode()})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # surface as JSON, keep serving
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def tiny_config():
    """The tiny uLLSAM of ``--tiny`` (the JAX CLI's ``make_configs``)."""
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    return FusionConfig(
        sam=SamConfig(
            vit=ViTConfig(img_size=64, patch_size=8, embed_dim=16, depth=2,
                          num_heads=2, mlp_ratio=2.0, out_chans=16,
                          window_size=2, global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                embed_dim=16, image_embedding_size=(8, 8),
                input_image_size=(64, 64), mask_in_chans=8),
            mask_decoder=MaskDecoderConfig(
                transformer_dim=16, transformer_mlp_dim=32,
                transformer_num_heads=2, iou_head_hidden_dim=8)),
        llm=InternLM2Config(vocab_size=92553, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=16)


def build_app(args, tokenizer=None) -> AppServer:
    """The model (random weights from seed 0, or ``--checkpoint``, a
    reference-named state dict), the tokenizer (``tokenizer``, or loaded
    from ``--tokenizer_path``) and, with ``--engine``, the caption
    engine."""
    import torch

    from ullsam_tpu_torch.core.config import (SAM_REGISTRY, FusionConfig,
                                              internlm2_1_8b)
    from ullsam_tpu_torch.models.ullsam import fusion as F

    cfg = (tiny_config() if args.tiny else
           FusionConfig(sam=SAM_REGISTRY[args.sam_variant](),
                        llm=internlm2_1_8b()))
    if tokenizer is None:
        from ullsam_tpu_torch.data.tokenizer import load_tokenizer
        tokenizer = load_tokenizer(args.tokenizer_path)
    dtype = getattr(torch, args.dtype)
    model = F.build_ullsam(cfg, device=args.device, dtype=dtype, seed=0)
    if args.checkpoint:
        state = torch.load(args.checkpoint, map_location=args.device,
                           weights_only=True)
        model.load_state_dict(state)
    engine = None
    if args.engine:
        from ullsam_tpu_torch.serve.engine import GenerationEngine
        engine = GenerationEngine(model, cfg, tokenizer,
                                  max_batch=args.engine_batch,
                                  max_len=args.max_len, quant=args.quant,
                                  device=args.device)
    app = AppServer(model, cfg, tokenizer, engine=engine)
    app.mode = args.mode
    if args.warmup:
        _warmup(app)
    return app


def _warmup(app: AppServer) -> None:
    """Run the interactive and caption paths once at boot (kernel builds,
    the engine's first graphs), so the first user request is served at
    steady-state latency."""
    t0 = time.time()
    size = app.cfg.sam.vit.img_size
    sess = app.session("__warmup__")
    app.set_image(sess, np.zeros((size, size, 3), np.uint8))
    sess.add_point(size / 2, size / 2, 1)
    app.generate_mask(sess)
    app.caption(sess, "Describe the image in detail.", max_new_tokens=2)
    with app.lock:
        app.sessions.pop("__warmup__", None)
    print(f"warmup done in {time.time() - t0:.0f}s")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="uLLSAM serving app (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9996,
                   help="reference port; 0 binds a free one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--sam_variant", default="vit_b")
    p.add_argument("--mode", choices=["v1", "baseline"], default="v1")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--engine", action="store_true",
                   help="continuous-batching caption engine")
    p.add_argument("--engine_batch", type=int, default=4)
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="weight-only int8 LLM for the caption engine "
                        "(serving only)")
    p.add_argument("--max_len", type=int, default=2560)
    p.add_argument("--warmup", action="store_true",
                   help="run the serving paths once at boot")
    p.add_argument("--smoke", action="store_true",
                   help="start, self-test the API, exit")
    return p.parse_args(argv)


def serve_smoke(app: AppServer, host: str = "127.0.0.1") -> bool:
    """Serve ``app`` on a free port of ``host`` and drive ``_smoke``
    against it; the server stops afterwards (the engine keeps running)."""
    server = ThreadingHTTPServer((host, 0), make_handler(app))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        return _smoke(host, server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def main(argv=None, tokenizer=None):
    args = parse_args(argv)
    app = build_app(args, tokenizer)
    if args.smoke:
        try:
            ok = serve_smoke(app, args.host if args.host != "0.0.0.0"
                             else "127.0.0.1")
        finally:
            if app.engine:
                app.engine.shutdown()
        raise SystemExit(0 if ok else 1)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    print(f"serving on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if app.engine:
            app.engine.shutdown()


def _smoke(host, port) -> bool:
    """Drive the API end-to-end: image -> clicks -> mask -> save ->
    export -> caption."""
    import urllib.request

    from PIL import Image

    def post(path, obj):
        req = urllib.request.Request(
            f"http://{host}:{port}{path}",
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:  # surface the server's error
            raise AssertionError(f"{path} -> {e.code}: "
                                 f"{e.read().decode()[:500]}") from e

    rng = np.random.RandomState(0)
    img = (rng.rand(96, 120, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()

    r = post("/api/image", {"session": "s", "image_b64": b64})
    assert r["ok"] and r["orig_hw"] == [96, 120], r
    post("/api/click", {"session": "s", "x": 500.0, "y": 400.0, "label": 1})
    post("/api/click", {"session": "s", "x": 100.0, "y": 800.0, "label": 0})
    r = post("/api/mask", {"session": "s"})
    assert r["ok"], r
    print("mask iou:", r["iou"], "t_mllm:", r["t_mllm"], "t_sam:", r["t_sam"])
    r = post("/api/save_instance", {"session": "s"})
    assert r["instance_id"] == 1, r
    r = post("/api/view", {"session": "s"})
    assert len(r["view_png_b64"]) > 100
    with urllib.request.urlopen(
            f"http://{host}:{port}/api/export?session=s") as resp:
        tiff = resp.read()
    arr = np.asarray(Image.open(io.BytesIO(tiff)))
    assert arr.shape == (96, 120), arr.shape
    assert arr.max() >= 1, "instance missing from export"
    r = post("/api/caption", {"session": "s", "max_new_tokens": 4})
    assert r["ok"] and isinstance(r["caption"], str), r
    print("caption:", repr(r["caption"][:50]))

    # SSE streaming caption: parse the event stream, require [DONE]
    req = urllib.request.Request(
        f"http://{host}:{port}/api/caption_stream",
        data=json.dumps({"session": "s", "max_new_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"})
    deltas, done = [], False
    with urllib.request.urlopen(req) as r:
        assert r.headers.get("Content-Type") == "text/event-stream"
        buf = r.read().decode()
    for ev in buf.split("\n\n"):
        if not ev.startswith("data: "):
            continue
        data = ev[len("data: "):]
        if data == "[DONE]":
            done = True
        else:
            obj = json.loads(data)
            assert "error" not in obj, obj
            deltas.append(obj["delta"])
    assert done, f"stream missing [DONE]: {buf[:200]!r}"
    print("stream caption:", repr("".join(deltas)[:50]),
          f"({len(deltas)} events)")
    print("SMOKE OK")
    return True


if __name__ == "__main__":
    main()
