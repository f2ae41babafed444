"""HTTP serving app: JSON chat API over the VitronSystem.

Port of `vitron_tpu/apps/serve.py`. The reference ships only a Gradio demo
that reloads backend checkpoints per request (reference: app.py:839-1131,
94-103). This is a minimal stdlib HTTP server with resident weights: POST
/chat with JSON {"prompt": str, "image": base64 image?, "sketch": base64
PNG?, "region": [x1,y1,x2,y2]?, "video_frames": [base64 PNG]?, "audio":
base64?, "temperature"?, "top_p"?, "max_new_tokens"?, "greedy"?} ->
{"status", "task"?, "text", "raw", "image"/"mask"/"video_frames" (base64
PNG)?}. GET /health reports the registered backends, GET /stats the memory
plan, the captured-graph caches (`runtime/telemetry.all_stats`) and the
continuous-batching occupancy, GET / the browser UI.

Connections are handled on threads (ThreadingHTTPServer); each request's
host preprocessing runs in the `ServingPipeline` worker pool and its LLM
prefill and decode on the pipeline's `ContinuousBatcher` device loop, so
concurrent requests co-batch their decode chunks.

    python -m vitron_tpu_torch.apps.serve --demo               # on the card
    python -m vitron_tpu_torch.apps.serve --demo --device cpu  # on the host
    python -m vitron_tpu_torch.apps.serve --weights weights/ --quantize int4
    python -m vitron_tpu_torch.apps.serve --base-model vicuna-7b --lora vitron_lora \
        --clip-tower clip_vit_l14 --video-tower languagebind_video --quantize int4

`--weights` serves the whole A-G deployment that
`runtime/assembly.build_system_from_weights` loads from a weights directory,
`--base-model` the chat system `build_mllm_system` loads from checkpoint
paths (the tokenizers through `transformers`); a component they need that is
missing, or the package, exits with code 2 and the reason. The device
defaults to `cuda`; without a CUDA device that is an error (exit 2), never a
switch to the CPU.
"""
from __future__ import annotations

import base64
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _encode_image(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _encode_result(result: Dict[str, Any]) -> Dict[str, Any]:
    out = {"status": result.get("status"), "task": result.get("task"),
           "text": result.get("text", "")}
    if result.get("reply"):
        out["raw"] = result["reply"]["raw"]
    if result.get("image") is not None:
        out["image"] = _encode_image(result["image"])
    if result.get("mask") is not None:
        out["mask"] = _encode_image(result["mask"].astype(np.uint8) * 255)
    if result.get("masks") is not None:
        out["masks"] = [_encode_image(m.astype(np.uint8) * 255)
                        for m in result["masks"]]
    if result.get("overlay") is not None:
        out["overlay"] = _encode_image(result["overlay"])
    if result.get("overlay_frames") is not None:
        out["overlay_frames"] = [_encode_image(f)
                                 for f in result["overlay_frames"]]
    if result.get("video") is not None:
        out["video_frames"] = [_encode_image(f) for f in result["video"]]
    if result.get("labels"):
        out["labels"] = {str(k): v for k, v in result["labels"].items()}
    if result.get("transcript"):
        out["transcript"] = result["transcript"]
    if result.get("error"):
        out["error"] = result["error"]
    return out


_INDEX_HTML = """<!doctype html>
<html><head><title>vitron</title><style>
body{font-family:sans-serif;max-width:860px;margin:1.5em auto;padding:0 1em}
textarea,input[type=file]{width:100%;margin:.3em 0}
#log{background:#f6f6f6;padding:1em;border-radius:6px;min-height:4em;
max-height:24em;overflow-y:auto}
.turn-u{color:#036;margin:.4em 0}.turn-a{color:#063;margin:.4em 0}
#wrap{position:relative;display:inline-block}#pad{position:absolute;left:0;
top:0;cursor:crosshair}img,canvas{max-width:100%}
button{margin-right:.4em}#media img{max-width:240px;margin:.2em}
.err{color:#a00}
</style></head><body>
<h2>vitron</h2>
<p>Unified pixel-level vision LLM - chat, segment, generate, edit, track.
Draw on the image to mark a region (Box) or sketch a mask (Stroke).
Upload a video for tracking/editing (8 frames are sampled client-side),
or an audio clip to refer to an object by speech.</p>
<div id="log"></div>
<textarea id="prompt" rows="2" placeholder="Ask something, or request a task
(segment the dog / track the object I circled / make a video of ...)"></textarea>
<label>image <input type="file" id="image" accept="image/*"></label>
<label>video <input type="file" id="video" accept="video/*"></label>
<label>audio <input type="file" id="audio" accept="audio/*"></label>
<div>
<label><input type="radio" name="mode" value="box" checked> Box</label>
<label><input type="radio" name="mode" value="stroke"> Stroke</label>
<button onclick="clearPad()">Clear sketch</button>
<label><input type="checkbox" id="greedy"> greedy</label>
<button onclick="send()">Send</button>
</div>
<div id="wrap"><img id="view" style="display:none">
<canvas id="pad" style="display:none"></canvas></div>
<div id="media"></div>
<script>
let imgEl=document.getElementById('view'),pad=document.getElementById('pad');
let ctx=null,drawing=false,box=null,hasStroke=false,natW=0,natH=0;
document.getElementById('image').addEventListener('change',e=>{
  const f=e.target.files[0]; if(!f) return;
  const fr=new FileReader();
  fr.onload=()=>{imgEl.src=fr.result;imgEl.style.display='block';
    imgEl.onload=()=>{natW=imgEl.naturalWidth;natH=imgEl.naturalHeight;
      pad.width=imgEl.width;pad.height=imgEl.height;pad.style.display='block';
      ctx=pad.getContext('2d');clearPad();};};
  fr.readAsDataURL(f);});
function mode(){return document.querySelector('input[name=mode]:checked').value;}
// switching draw mode resets stale state: a leftover stroke flag would
// otherwise send the box outline as a sketch mask (and vice versa)
document.querySelectorAll('input[name=mode]').forEach(r=>
  r.addEventListener('change',clearPad));
function pos(e){const r=pad.getBoundingClientRect();
  return [e.clientX-r.left,e.clientY-r.top];}
pad.addEventListener('mousedown',e=>{drawing=true;const [x,y]=pos(e);
  if(mode()==='box'){box=[x,y,x,y];}else{ctx.beginPath();ctx.moveTo(x,y);
    ctx.strokeStyle='rgba(255,0,0,0.8)';ctx.lineWidth=8;hasStroke=true;}});
pad.addEventListener('mousemove',e=>{if(!drawing)return;const [x,y]=pos(e);
  if(mode()==='box'){box[2]=x;box[3]=y;redrawBox();}
  else{ctx.lineTo(x,y);ctx.stroke();}});
window.addEventListener('mouseup',()=>drawing=false);
function redrawBox(){ctx.clearRect(0,0,pad.width,pad.height);
  ctx.strokeStyle='red';ctx.lineWidth=2;
  ctx.strokeRect(box[0],box[1],box[2]-box[0],box[3]-box[1]);}
function clearPad(){if(ctx)ctx.clearRect(0,0,pad.width,pad.height);
  box=null;hasStroke=false;}
function scaleBox(b){const sx=natW/pad.width,sy=natH/pad.height;
  return [Math.min(b[0],b[2])*sx,Math.min(b[1],b[3])*sy,
          Math.max(b[0],b[2])*sx,Math.max(b[1],b[3])*sy];}
function maskB64(){const c=document.createElement('canvas');
  c.width=natW;c.height=natH;const g=c.getContext('2d');
  g.fillStyle='black';g.fillRect(0,0,natW,natH);
  g.drawImage(pad,0,0,pad.width,pad.height,0,0,natW,natH);
  return c.toDataURL('image/png').split(',')[1];}
function append(cls,html){const log=document.getElementById('log');
  const d=document.createElement('div');d.className=cls;d.innerHTML=html;
  log.appendChild(d);log.scrollTop=log.scrollHeight;}
function fileB64(f){return new Promise(r=>{const fr=new FileReader();
  fr.onload=()=>r(fr.result.split(',')[1]);fr.readAsDataURL(f);});}
// sample n frames uniformly (mirrors the server's 8-frame linspace,
// media/preprocess.py) so videos upload as a small PNG list
async function sampleVideo(f,n=8){
  const url=URL.createObjectURL(f);const v=document.createElement('video');
  v.src=url;v.muted=true;
  await new Promise((res,rej)=>{v.onloadedmetadata=res;v.onerror=rej;});
  const c=document.createElement('canvas');
  c.width=v.videoWidth;c.height=v.videoHeight;
  const g=c.getContext('2d');const frames=[];
  for(let i=0;i<n;i++){
    const t=Math.min(v.duration*i/Math.max(n-1,1),
                     Math.max(v.duration-0.05,0));
    await new Promise(res=>{v.onseeked=res;v.currentTime=t;});
    g.drawImage(v,0,0);
    frames.push(c.toDataURL('image/png').split(',')[1]);}
  URL.revokeObjectURL(url);return frames;}
// returned-frames playback: cycle the PNG list at 8 fps
function playFrames(frames,w){
  const img=document.createElement('img');img.width=w||320;let i=0;
  img.src='data:image/png;base64,'+frames[0];
  setInterval(()=>{i=(i+1)%frames.length;
    img.src='data:image/png;base64,'+frames[i];},125);
  return img;}
async function send(){
  const media=document.getElementById('media'); media.innerHTML='';
  const promptText=document.getElementById('prompt').value;
  append('turn-u','<b>you:</b> '+promptText);
  const body={prompt:promptText,
              greedy:document.getElementById('greedy').checked};
  const f=document.getElementById('image').files[0];
  if(f){body.image=await fileB64(f);}
  const vf=document.getElementById('video').files[0];
  if(vf){try{body.video_frames=await sampleVideo(vf);}
    catch(e){append('turn-a err','<b>error:</b> video decode failed');return;}}
  const af=document.getElementById('audio').files[0];
  if(af){body.audio=await fileB64(af);}
  if(box&&mode()==='box'){body.region=scaleBox(box);}
  if(hasStroke){body.sketch=maskB64();}
  const resp=await fetch('/chat',{method:'POST',
    headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
  const j=await resp.json();
  if(j.error){append('turn-a err','<b>error:</b> '+j.error);return;}
  append('turn-a','<b>vitron'+(j.task?' ['+j.task+']':'')+':</b> '+
         (j.text||j.raw||''));
  if(j.transcript)append('turn-a','<i>heard:</i> '+j.transcript);
  for(const k of ['image','overlay','mask']) if(j[k])
    media.innerHTML+=`<img src="data:image/png;base64,${j[k]}">`;
  for(const k of ['video_frames','overlay_frames']) if(j[k]){
    media.appendChild(playFrames(j[k]));
    for(const fimg of j[k]){const im=document.createElement('img');
      im.width=96;im.src='data:image/png;base64,'+fimg;
      media.appendChild(im);}}
}
</script></body></html>"""

def make_handler(system, pipeline=None):
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline

    if pipeline is None:
        pipeline = ServingPipeline(system)

    class Handler(BaseHTTPRequestHandler):
        serving_pipeline = pipeline

        def _send(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "backends": system.registry.available()})
            elif self.path == "/stats":
                from vitron_tpu_torch.runtime import telemetry

                plan = system.memory_plan
                self._send(200, {
                    "backends": system.registry.available(),
                    "resident_bytes": plan.resident_bytes,
                    "budget_bytes": plan.budget_bytes,
                    "fits": plan.fits,
                    "entries": plan.entries,
                    "report": plan.report(),
                    # captured-graph caches (bounded LRU each; runtime/telemetry.py)
                    "programs": telemetry.all_stats(),
                    # continuous-batching occupancy (runtime/batching.py)
                    **({"batching": pipeline.batcher.stats()}
                       if pipeline.batcher is not None else {}),
                })
            elif self.path in ("/", "/index.html"):
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/chat":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                image = _decode_image(req["image"]) if req.get("image") else None
                sketch = None
                if req.get("sketch"):
                    # white strokes on black from the UI sketch pad
                    sketch = _decode_image(req["sketch"]).max(axis=-1) > 127
                video = None
                if req.get("video_frames"):
                    video = np.stack([_decode_image(f) for f in req["video_frames"]])
                extra = {}
                if req.get("audio"):
                    # the audio bytes go to the ASR hook when module B
                    # routes with audio (runtime/system.py handle_b); with
                    # no hook registered the reply is its error
                    extra["audio"] = base64.b64decode(req["audio"])
                if req.get("audio_transcript"):
                    extra["audio_transcript"] = str(req["audio_transcript"])
                sampling = SamplingConfig(
                    temperature=float(req.get("temperature", 0.2)),
                    top_p=float(req.get("top_p", 0.7)),
                    max_new_tokens=int(req.get("max_new_tokens", 1024)),
                    greedy=bool(req.get("greedy", False)))
                result = pipeline.submit(
                    req.get("prompt", ""), image=image, video=video, sketch_mask=sketch,
                    region_box=req.get("region"), sampling=sampling,
                    extra=extra or None).result()
                self._send(200, _encode_result(result))
            except Exception as e:  # report, don't crash the server
                self._send(500, {"status": "error", "error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(system, host: str = "127.0.0.1", port: int = 8080,
          background: bool = False) -> Optional[HTTPServer]:
    """Serve `system`; background=True returns the running server, whose
    `pipeline` the caller closes after `shutdown()`."""
    handler = make_handler(system)
    server = ThreadingHTTPServer((host, port), handler)
    server.pipeline = handler.serving_pipeline
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    print(f"vitron serving on http://{host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.pipeline.close()
    return None


def host_memory_bytes() -> int:
    """The host's physical memory: the budget of a memory plan on the CPU."""
    import os

    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def build_serving_system(args):
    """The checkpoint flags -> (system, report) on `args.device`: `--weights`
    the whole A-G deployment (`assembly.build_system_from_weights`, the
    reference app.py:59-63 start-up), `--base-model` chat only
    (`assembly.build_mllm_system`). Off the card the memory plan's budget
    is the host's memory."""
    from vitron_tpu_torch.runtime import assembly
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan

    device = assembly.resolve_device(args.device)
    kw = dict(geometry=args.geometry, quantize=args.quantize,
              mesh={"auto": "auto", "none": None}[args.mesh],
              allow_random_towers=args.allow_random_towers, device=device,
              memory_plan=None if device.type == "cuda" else MemoryPlan(
                  budget_bytes=host_memory_bytes()))
    if args.weights:
        return assembly.build_system_from_weights(args.weights, **kw)
    return assembly.build_mllm_system(args.base_model, lora=args.lora,
                                      clip_tower=args.clip_tower,
                                      video_tower=args.video_tower, **kw)


def add_checkpoint_args(p) -> None:
    """The serve / CLI checkpoint flags."""
    p.add_argument("--weights", metavar="DIR",
                   help="weights dir (the reference layout, runtime/assembly.py): loads "
                        "every component present and registers tasks A-G")
    p.add_argument("--base-model", help="HF Llama/Vicuna checkpoint dir (chat only, the "
                                        "alternative to --weights)")
    p.add_argument("--lora", help="LoRA adapter dir (merged at load), with "
                                  "non_lora_trainables.bin")
    p.add_argument("--clip-tower", help="HF CLIP vision tower dir (with --base-model)")
    p.add_argument("--video-tower", help="LanguageBind video tower dir (with --base-model)")
    p.add_argument("--quantize", choices=("", "int8", "int4"), default="",
                   help="weight-only LLM quantization")
    p.add_argument("--geometry", choices=("real", "tiny"), default="real",
                   help="checkpoint geometry (tiny: the synthetic test shapes; real: bf16 "
                        "towers)")
    p.add_argument("--mesh", choices=("auto", "none"), default="auto",
                   help="auto: one device (a mesh over several is ROADMAP A16)")
    p.add_argument("--allow-random-towers", action="store_true",
                   help="permit missing vision towers (smoke tests only: image questions "
                        "are answered by a random-init tower)")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Vitron PyTorch/CUDA HTTP server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    p.add_argument("--demo", action="store_true",
                   help="random tiny weights, whitespace tokenizer (no checkpoints)")
    p.add_argument("--seed", type=int, default=0)
    add_checkpoint_args(p)
    args = p.parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    if args.demo:
        from vitron_tpu_torch.apps.cli import build_demo_system

        serve(build_demo_system(device, args.seed), args.host, args.port)
        return 0
    if not args.weights and not args.base_model:
        print("error: provide --weights DIR (the A-G deployment), --base-model (chat only) "
              "or --demo", file=sys.stderr)
        return 2
    from vitron_tpu_torch.runtime.assembly import MissingWeightsError

    try:
        system, report = build_serving_system(args)
    except (MissingWeightsError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(report.summary(), flush=True)
    serve(system, args.host, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
