"""Self-contained interactive HTML point-cloud viewer; a numpy copy of
``icet_tpu/viz_html.py``.  Its functions take numpy arrays or tensors
(on any device), each moved to the host once.

The reference's interactive L4 is a live vedo/VTK Plotter window
(ICET_spherical.py:1091-1203 draws clouds, voxel ellipsoids and the
solution overlay into an OpenGL window the user orbits with the mouse).
A GPU server is headless, so this module renders the same artifacts into ONE
portable .html file with an embedded WebGL renderer — no network, no
external libraries, no install: scp it anywhere and open it in a browser.
Mouse: drag = orbit, wheel = zoom, shift-drag / right-drag = pan,
keys 1..9 toggle layers.

Data is embedded as base64 little-endian float32 xyz triples, decoded in
JS straight into GPU vertex buffers, so a 200k-point scene stays a ~3 MB
file that loads instantly.
"""

from __future__ import annotations

import base64
import html as _html
import json

import numpy as np
import torch

# Default layer colors (rgb in 0-1): blue, red, green, orange, purple, teal.
_COLORS = [
    (0.30, 0.55, 0.95),
    (0.95, 0.35, 0.30),
    (0.35, 0.80, 0.45),
    (0.95, 0.65, 0.20),
    (0.70, 0.45, 0.90),
    (0.25, 0.75, 0.75),
]


def _host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor is copied to the host once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack_points(pts, max_pts):
    pts = np.asarray(_host(pts), np.float32).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    pts = pts[np.linalg.norm(pts, axis=1) > 1e-6]
    if len(pts) > max_pts:
        idx = np.linspace(0, len(pts) - 1, max_pts).astype(int)
        pts = pts[idx]
    return pts


def ellipsoid_wireframe(mean, cov, scale: float = 2.0, segments: int = 24):
    """Three principal-plane circles of the ``scale``-sigma ellipsoid of
    ``cov`` centred at ``mean`` — the wireframe analog of the reference's
    solid vedo ellipsoids (utils.py Ell) — as a list of (segments+1, 3)
    polylines."""
    mean = np.asarray(_host(mean), np.float64).reshape(3)
    cov = np.asarray(_host(cov), np.float64).reshape(3, 3)
    w, v = np.linalg.eigh((cov + cov.T) / 2)
    radii = scale * np.sqrt(np.maximum(w, 0.0))
    t = np.linspace(0.0, 2 * np.pi, segments + 1)
    circles = []
    for a, b in ((0, 1), (0, 2), (1, 2)):
        ring = (
            np.outer(np.cos(t), radii[a] * v[:, a])
            + np.outer(np.sin(t), radii[b] * v[:, b])
            + mean
        )
        circles.append(ring.astype(np.float32))
    return circles


def save_html(
    path,
    clouds,
    labels=None,
    colors=None,
    lines=None,
    line_labels=None,
    title: str = "icet_tpu viewer",
    max_pts: int = 200_000,
    point_size: float = 2.0,
) -> str:
    """Write a standalone interactive WebGL viewer.

    clouds: list of (N, 3) arrays (each becomes a toggleable layer).
    lines: optional list of polylines ((M, 3) arrays) — trajectories,
        snail trails, ellipsoid wireframes (see :func:`ellipsoid_wireframe`).
    Returns ``path``.
    """
    clouds = [_pack_points(c, max_pts) for c in clouds]
    labels = list(labels or [f"cloud {i}" for i in range(len(clouds))])
    lines = [np.asarray(_host(l), np.float32).reshape(-1, 3) for l in (lines or [])]
    line_labels = list(line_labels or [f"line {i}" for i in range(len(lines))])

    layers = []
    for i, c in enumerate(clouds):
        col = (colors[i] if colors is not None and i < len(colors)
               else _COLORS[i % len(_COLORS)])
        layers.append({
            "label": str(labels[i]),
            "color": [float(x) for x in col],
            "kind": "points",
            "n": int(len(c)),
            "data": base64.b64encode(
                np.ascontiguousarray(c, "<f4").tobytes()).decode(),
        })
    for i, l in enumerate(lines):
        col = _COLORS[(len(clouds) + i) % len(_COLORS)]
        layers.append({
            "label": str(line_labels[i]),
            "color": [float(x) for x in col],
            "kind": "line",
            "n": int(len(l)),
            "data": base64.b64encode(
                np.ascontiguousarray(l, "<f4").tobytes()).decode(),
        })

    all_pts = np.concatenate([c for c in clouds if len(c)] + [l for l in lines if len(l)]) \
        if any(len(c) for c in clouds) or any(len(l) for l in lines) else np.zeros((1, 3), np.float32)
    center = all_pts.mean(axis=0)
    radius = float(max(np.percentile(np.linalg.norm(all_pts - center, axis=1), 95), 1e-3))

    scene = json.dumps({
        "layers": layers,
        "center": [float(x) for x in center],
        "radius": radius,
        "pointSize": float(point_size),
    })
    doc = (
        _TEMPLATE
        .replace("__TITLE__", _html.escape(str(title)))
        .replace("__SCENE__", scene)
    )
    with open(path, "w") as f:
        f.write(doc)
    return path


def save_registration_html(path, scan1, scan2, X, max_pts=150_000,
                           title="registration"):
    """scan1 vs scan2-before vs scan2-aligned-by-X, one toggleable layer
    each (the reference demo's before/after overlay)."""
    from icet_tpu_torch.ops.geometry import transform_points

    scan1, scan2 = _host(scan1), _host(scan2)
    aligned = transform_points(torch.as_tensor(np.asarray(scan2, np.float32)),
                               torch.as_tensor(np.asarray(_host(X), np.float32))).numpy()
    return save_html(
        path,
        [scan1, scan2, aligned],
        labels=["scan 1 (reference)", "scan 2 (raw)", "scan 2 (aligned)"],
        title=title,
        max_pts=max_pts // 3,
    )


def save_map_html(path, map_points, trail=None, title="HD map",
                  max_pts=300_000):
    """HD map + snail trail (the reference's /hd_map + /snail_trail_topic
    RViz view, simpleMapMaker.cpp:212-230)."""
    trail = None if trail is None else _host(trail)
    lines = [trail] if trail is not None and len(trail) else None
    return save_html(
        path, [map_points], labels=["map"], lines=lines,
        line_labels=["trail"], title=title, max_pts=max_pts,
    )


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#10131a;color:#cfd6e4;font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:10px;left:10px;background:rgba(16,19,26,.85);padding:10px 12px;
      border:1px solid #2a3040;border-radius:8px;max-width:280px}
 #hud h1{font-size:14px;margin:0 0 6px}
 #hud label{display:block;cursor:pointer;margin:2px 0;user-select:none}
 #hud .sw{display:inline-block;width:10px;height:10px;border-radius:2px;margin-right:6px}
 #hud .dim{opacity:.55;font-size:11px;margin-top:6px}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><h1>__TITLE__</h1><div id="layers"></div>
<div class="dim">drag orbit &middot; wheel zoom &middot; shift/right-drag pan &middot; keys 1-9 toggle</div></div>
<script>
"use strict";
const SCENE = __SCENE__;
function decode(b64){
  const s = atob(b64), n = s.length, u = new Uint8Array(n);
  for (let i = 0; i < n; i++) u[i] = s.charCodeAt(i);
  return new Float32Array(u.buffer);
}
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:true});
const VS = `attribute vec3 p;uniform mat4 mvp;uniform float psz;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psz;}`;
const FS = `precision mediump float;uniform vec3 col;
void main(){gl_FragColor=vec4(col,1.0);}`;
function shader(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const aP = gl.getAttribLocation(prog, "p");
const uMVP = gl.getUniformLocation(prog, "mvp");
const uCol = gl.getUniformLocation(prog, "col");
const uPsz = gl.getUniformLocation(prog, "psz");
gl.enableVertexAttribArray(aP);
gl.enable(gl.DEPTH_TEST);

const layers = SCENE.layers.map(function(L){
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, decode(L.data), gl.STATIC_DRAW);
  return {buf:buf, n:L.n, color:L.color, kind:L.kind, label:L.label, on:true};
});

// mat4 helpers (column-major)
function mul(a,b){const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function persp(fov,asp,near,far){const f=1/Math.tan(fov/2),o=new Float32Array(16);
 o[0]=f/asp;o[5]=f;o[10]=(far+near)/(near-far);o[11]=-1;o[14]=2*far*near/(near-far);return o;}

let az=0.6, el=0.4, dist=SCENE.radius*2.5, tgt=SCENE.center.slice();
function view(){
  const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
  const eye=[tgt[0]+dist*ce*ca, tgt[1]+dist*ce*sa, tgt[2]+dist*se];
  const f=norm3([tgt[0]-eye[0],tgt[1]-eye[1],tgt[2]-eye[2]]);
  const up=[0,0,1];
  const s=norm3(cross(f,up)), u=cross(s,f);
  return new Float32Array([
    s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
    -dot(s,eye),-dot(u,eye),dot(f,eye),1]);
}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(v){const n=Math.hypot(v[0],v[1],v[2])||1;return [v[0]/n,v[1]/n,v[2]/n];}

function draw(){
  const w=canvas.clientWidth,h=canvas.clientHeight;
  if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;gl.viewport(0,0,w,h);}
  gl.clearColor(0.063,0.075,0.102,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const mvp=mul(persp(0.9,w/h,SCENE.radius*0.01,SCENE.radius*40),view());
  gl.uniformMatrix4fv(uMVP,false,mvp);
  gl.uniform1f(uPsz,SCENE.pointSize);
  for(const L of layers){
    if(!L.on||!L.n)continue;
    gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
    gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.uniform3fv(uCol,L.color);
    gl.drawArrays(L.kind==="line"?gl.LINE_STRIP:gl.POINTS,0,L.n);
  }
  requestAnimationFrame(draw);
}
function resize(){canvas.style.width=innerWidth+"px";canvas.style.height=innerHeight+"px";}
addEventListener("resize",resize);resize();

let drag=null;
canvas.addEventListener("contextmenu",e=>e.preventDefault());
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,pan:e.button===2||e.shiftKey};});
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
  if(drag.pan){
    const s=dist*0.0015,ca=Math.cos(az),sa=Math.sin(az);
    tgt[0]+=s*(dx*sa); tgt[1]+=s*(-dx*ca); tgt[2]+=s*dy;
  }else{az-=dx*0.006; el=Math.min(1.5,Math.max(-1.5,el+dy*0.006));}
});
canvas.addEventListener("wheel",e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);},{passive:false});
addEventListener("keydown",e=>{
  const i=e.keyCode-49;
  if(i>=0&&i<layers.length){layers[i].on=!layers[i].on;sync();}
});

const box=document.getElementById("layers");
function sync(){
  box.innerHTML="";
  layers.forEach(function(L,i){
    const lab=document.createElement("label");
    const c=L.color.map(x=>Math.round(x*255));
    lab.innerHTML='<span class="sw" style="background:rgb('+c+')"></span>'+
      (i+1)+". "+L.label+" ("+L.n+(L.kind==="line"?" verts":" pts")+")"+(L.on?"":" [off]");
    lab.style.opacity=L.on?1:.45;
    lab.onclick=function(){L.on=!L.on;sync();};
    box.appendChild(lab);
  });
}
sync();
requestAnimationFrame(draw);
</script></body></html>
"""
