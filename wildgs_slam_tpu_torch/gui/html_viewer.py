"""Self-contained interactive HTML viewers of the Gaussian map; the port's
own copy of ``wildgs_slam_tpu/gui/html_viewer.py``.

``export_viewer_from_map`` writes a WebGL2 sort-and-blend splat viewer of
the alive Gaussians and, beside it as ``<name>_points.html``, a 2D-canvas
point view; both single HTML files with the map embedded, no external
dependencies. ``write_live_viewer`` writes the live page that polls the
``map.json`` snapshots ``map_snapshot_json`` serializes (the file GUI
writes both). The bytes equal the JAX package's for the same inputs.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>wildgs_slam_tpu map</title>
<style>body{margin:0;background:#0b0b12;color:#9aa;overflow:hidden;
font-family:monospace}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">__NPTS__ gaussians · drag=orbit · wheel=zoom ·
shift-drag=pan</div><canvas id="c"></canvas><script>
const B64="__DATA__";
const raw=Uint8Array.from(atob(B64),ch=>ch.charCodeAt(0));
const f32=new Float32Array(raw.buffer);
const N=__NPTS__;
const pos=f32.subarray(0,3*N), col=f32.subarray(3*N,6*N),
      sca=f32.subarray(6*N,7*N);
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs();addEventListener("resize",()=>{rs();draw();});
// center + scale
let cx=0,cy=0,cz=0;for(let i=0;i<N;i++){cx+=pos[3*i];cy+=pos[3*i+1];
cz+=pos[3*i+2];}cx/=N;cy/=N;cz/=N;
let yaw=0.5,pitch=-0.4,dist=6,panx=0,pany=0;
let drag=false,panm=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;panm=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
lx=e.clientX;ly=e.clientY;
if(panm){panx+=dx*dist/500;pany+=dy*dist/500;}else{yaw+=dx*.005;
pitch+=dy*.005;}draw();};
onwheel=e=>{dist*=Math.exp(e.deltaY*.001);draw();};
const ord=new Int32Array(N);const zbuf=new Float32Array(N);
function draw(){
 ctx.fillStyle="#0b0b12";ctx.fillRect(0,0,W,H);
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),
       cp=Math.cos(pitch),f=0.9*Math.min(W,H);
 for(let i=0;i<N;i++){
  let x=pos[3*i]-cx,y=pos[3*i+1]-cy,z=pos[3*i+2]-cz;
  let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
  let y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  zbuf[i]=z2+dist;ord[i]=i;
 }
 ord.sort((a,b)=>zbuf[b]-zbuf[a]);
 for(let k=0;k<N;k++){const i=ord[k];const zc=zbuf[i];
  if(zc<=0.05)continue;
  let x=pos[3*i]-cx,y=pos[3*i+1]-cy,z=pos[3*i+2]-cz;
  let x1=Math.cos(yaw)*x+Math.sin(yaw)*z,
      z1=-Math.sin(yaw)*x+Math.cos(yaw)*z;
  let y2=Math.cos(pitch)*y-Math.sin(pitch)*z1;
  const sx=W/2+f*(x1+panx)/zc, syp=H/2+f*(y2+pany)/zc;
  const r=Math.max(0.7,Math.min(12,f*sca[i]/zc));
  ctx.fillStyle=`rgb(${col[3*i]*255|0},${col[3*i+1]*255|0},`+
                `${col[3*i+2]*255|0})`;
  ctx.beginPath();ctx.arc(sx,syp,r,0,6.283);ctx.fill();}
}
draw();
</script></body></html>
"""


_LIVE_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>wildgs_slam_tpu live map</title>
<style>body{margin:0;background:#0b0b12;color:#9aa;overflow:hidden;
font-family:monospace}#hud{position:fixed;top:8px;left:8px}
button{background:#333;color:#eee;border:1px solid #666;margin:2px;
padding:3px 9px;cursor:pointer}</style></head>
<body><div id="hud"><span id="st">loading…</span> · drag=orbit ·
wheel=zoom · shift-drag=pan<br>__CONTROLS__</div>
<canvas id="c"></canvas><script>
let N=0,pos=null,col=null,sca=null,rev=-1;
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs();addEventListener("resize",()=>{rs();draw();});
let cx=0,cy=0,cz=0,yaw=0.5,pitch=-0.4,dist=6,panx=0,pany=0;
let drag=false,panm=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;panm=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
lx=e.clientX;ly=e.clientY;
if(panm){panx+=dx*dist/500;pany+=dy*dist/500;}else{yaw+=dx*.005;
pitch+=dy*.005;}draw();};
onwheel=e=>{dist*=Math.exp(e.deltaY*.001);draw();};
function b64f32(s){const r=Uint8Array.from(atob(s),c=>c.charCodeAt(0));
return new Float32Array(r.buffer);}
async function poll(){
 try{
  const m=await (await fetch("map.json?r="+Math.random())).json();
  if(m.rev!==rev){rev=m.rev;N=m.n;
   pos=b64f32(m.pos);col=b64f32(m.col);sca=b64f32(m.sca);
   cx=0;cy=0;cz=0;for(let i=0;i<N;i++){cx+=pos[3*i];cy+=pos[3*i+1];
   cz+=pos[3*i+2];}cx/=N;cy/=N;cz/=N;
   document.getElementById("st").textContent=
     m.n+" gaussians · frame "+m.frame;
   draw();}
 }catch(e){document.getElementById("st").textContent="waiting for map…";}
 setTimeout(poll,2000);}
poll();
let ord=null,zbuf=null;
function draw(){
 if(!pos)return;
 if(!ord||ord.length!==N){ord=new Int32Array(N);zbuf=new Float32Array(N);}
 ctx.fillStyle="#0b0b12";ctx.fillRect(0,0,W,H);
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),
       cp=Math.cos(pitch),f=0.9*Math.min(W,H);
 for(let i=0;i<N;i++){
  let x=pos[3*i]-cx,y=pos[3*i+1]-cy,z=pos[3*i+2]-cz;
  let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
  let z2=sp*y+cp*z1;
  zbuf[i]=z2+dist;ord[i]=i;
 }
 ord.sort((a,b)=>zbuf[b]-zbuf[a]);
 for(let k=0;k<N;k++){const i=ord[k];const zc=zbuf[i];
  if(zc<=0.05)continue;
  let x=pos[3*i]-cx,y=pos[3*i+1]-cy,z=pos[3*i+2]-cz;
  let x1=cyw*x+Math.sin(yaw)*z,
      z1=-Math.sin(yaw)*x+cyw*z;
  let y2=Math.cos(pitch)*y-Math.sin(pitch)*z1;
  const sx=W/2+f*(x1+panx)/zc, syp=H/2+f*(y2+pany)/zc;
  const r=Math.max(0.7,Math.min(12,f*sca[i]/zc));
  ctx.fillStyle=`rgb(${col[3*i]*255|0},${col[3*i+1]*255|0},`+
                `${col[3*i+2]*255|0})`;
  ctx.beginPath();ctx.arc(sx,syp,r,0,6.283);ctx.fill();}
}
</script></body></html>
"""

_LIVE_CONTROLS = """<button onclick="fetch('http://127.0.0.1:__PORT__/pause')">pause</button>
<button onclick="fetch('http://127.0.0.1:__PORT__/resume')">resume</button>
<button onclick="fetch('http://127.0.0.1:__PORT__/checkpoint')">checkpoint</button>
<button onclick="fetch('http://127.0.0.1:__PORT__/stop')">stop</button>"""


def write_live_viewer(path: str, http_port: int | None = None) -> str:
    """Write the LIVE map viewer page: polls `map.json` (written next to it
    by FileGui.push every keyframe) and redraws the orbiting point cloud —
    the reference's live Open3D gaussian view (src/gui/slam_gui.py), over
    any static file server. Control buttons included when the control
    channel's HTTP port is known."""
    controls = (_LIVE_CONTROLS.replace("__PORT__", str(http_port))
                if http_port else "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(_LIVE_TEMPLATE.replace("__CONTROLS__", controls))
    return path


def map_snapshot_json(xyz: np.ndarray, rgb: np.ndarray, scales: np.ndarray,
                      frame_idx: int, rev: int,
                      max_points: int = 60000) -> str:
    """Serialize a (downsampled) map snapshot for the live viewer."""
    n = xyz.shape[0]
    if n > max_points:
        sel = np.random.RandomState(rev).choice(n, max_points, replace=False)
        xyz, rgb, scales = xyz[sel], rgb[sel], scales[sel]
        n = max_points
    enc = lambda a: base64.b64encode(
        np.ascontiguousarray(a, np.float32).tobytes()).decode("ascii")
    return json.dumps({
        "n": int(n), "rev": int(rev), "frame": int(frame_idx),
        "pos": enc(xyz.reshape(-1)),
        "col": enc(np.clip(rgb, 0, 1).reshape(-1)),
        "sca": enc(scales.reshape(-1)),
    })


def export_viewer(path: str, xyz: np.ndarray, rgb: np.ndarray,
                  scales: np.ndarray, max_points: int = 200000) -> str:
    """Write the standalone viewer. xyz (N,3); rgb (N,3) in [0,1];
    scales (N,) mean world-space scale per point."""
    n = xyz.shape[0]
    if n > max_points:
        sel = np.random.RandomState(0).choice(n, max_points, replace=False)
        xyz, rgb, scales = xyz[sel], rgb[sel], scales[sel]
        n = max_points
    blob = np.concatenate([
        np.asarray(xyz, np.float32).reshape(-1),
        np.clip(np.asarray(rgb, np.float32), 0, 1).reshape(-1),
        np.asarray(scales, np.float32).reshape(-1),
    ]).tobytes()
    html = (_TEMPLATE
            .replace("__NPTS__", str(n))
            .replace("__DATA__", base64.b64encode(blob).decode("ascii")))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


_SPLAT_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>wildgs_slam_tpu splats</title>
<style>body{margin:0;background:#0b0b12;color:#9aa;overflow:hidden;
font-family:monospace}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">__NPTS__ gaussians (EWA splats) · drag=orbit ·
wheel=zoom · shift-drag=pan</div><canvas id="c"></canvas><script>
// WebGL2 sort-and-blend gaussian splatting — the TPU build's analogue of
// the reference's GLSL renderer (gl_render/render_ogl.py + gau_vert.glsl):
// per-splat 2D covariance by EWA projection in the vertex shader, quads
// sized to 3 sigma, exp falloff in the fragment shader, back-to-front
// CPU depth sort, premultiplied-alpha OVER blending.
const B64="__DATA__";
const raw=Uint8Array.from(atob(B64),ch=>ch.charCodeAt(0));
const f32=new Float32Array(raw.buffer);
const N=__NPTS__;
const pos=f32.subarray(0,3*N), colop=f32.subarray(3*N,7*N),
      cov=f32.subarray(7*N,13*N);     // packed upper-tri 3D covariance
const cv=document.getElementById("c");
const gl=cv.getContext("webgl2",{antialias:false});
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;
gl.viewport(0,0,W,H);}
rs();addEventListener("resize",()=>{rs();draw();});
const VS=`#version 300 es
precision highp float;
layout(location=0) in vec2 corner;      // unit quad
layout(location=1) in vec3 p;           // splat center (world)
layout(location=2) in vec4 co;          // rgb + opacity
layout(location=3) in vec3 cA;          // cov3d xx xy xz
layout(location=4) in vec3 cB;          // cov3d yy yz zz
uniform mat3 R; uniform vec3 T; uniform vec2 res; uniform float fl;
out vec4 vco; out vec2 vd; out vec3 vconic;
void main(){
  vec3 q = R*(p) + T;                   // view space
  if(q.z < 0.05){ gl_Position=vec4(0,0,2,1); return; }
  mat3 S = mat3(cA.x,cA.y,cA.z, cA.y,cB.x,cB.y, cA.z,cB.y,cB.z);
  mat3 V = R*S*transpose(R);            // view-space cov
  float iz=1.0/q.z;
  // EWA Jacobian of pinhole projection. GLSL mat3() fills COLUMNS, so
  // this J has abstract rows (fl/z, 0, -fl x/z^2), (0, fl/z, -fl y/z^2)
  // — the row-major EWA J (the CUDA reference builds the transpose and
  // flips the product order, forward.cu computeCov2D)
  mat3 J = mat3(fl*iz,0.0,0.0, 0.0,fl*iz,0.0,
                -fl*q.x*iz*iz,-fl*q.y*iz*iz,0.0);
  mat3 C = J*V*transpose(J);
  float a=C[0][0]+0.3, b=C[0][1], c=C[1][1]+0.3;
  float det=a*c-b*b; if(det<=0.0){ gl_Position=vec4(0,0,2,1); return; }
  vconic=vec3(c,-b,a)/det;
  float mid=0.5*(a+c);
  float l1=mid+sqrt(max(0.01,mid*mid-det));
  float rad=ceil(3.0*sqrt(l1));
  vec2 center=vec2(fl*q.x*iz, fl*q.y*iz);
  vd=corner*rad;
  vec2 ndc=(center+vd)/(0.5*res);
  gl_Position=vec4(ndc.x,-ndc.y,0.0,1.0);
  vco=co;
}`;
const FS=`#version 300 es
precision highp float;
in vec4 vco; in vec2 vd; in vec3 vconic; out vec4 o;
void main(){
  float power=-0.5*(vconic.x*vd.x*vd.x+vconic.z*vd.y*vd.y)
              -vconic.y*vd.x*vd.y;
  if(power>0.0) discard;
  float alpha=min(0.99, vco.a*exp(power));
  if(alpha<0.00392) discard;
  o=vec4(vco.rgb*alpha, alpha);         // premultiplied OVER
}`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);
gl.compileShader(h);if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))
throw gl.getShaderInfoLog(h);return h;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const uR=gl.getUniformLocation(prog,"R"),uT=gl.getUniformLocation(prog,"T"),
      ures=gl.getUniformLocation(prog,"res"),
      ufl=gl.getUniformLocation(prog,"fl");
const quad=new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
const qb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,qb);
gl.bufferData(gl.ARRAY_BUFFER,quad,gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);
// sorted per-instance buffers (rewritten on re-sort)
const ipos=new Float32Array(3*N), ico=new Float32Array(4*N),
      icA=new Float32Array(3*N), icB=new Float32Array(3*N);
function mkbuf(loc,dim,arr){const b=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,b);
gl.bufferData(gl.ARRAY_BUFFER,arr,gl.DYNAMIC_DRAW);
gl.enableVertexAttribArray(loc);
gl.vertexAttribPointer(loc,dim,gl.FLOAT,false,0,0);
gl.vertexAttribDivisor(loc,1);return b;}
const bpos=mkbuf(1,3,ipos),bco=mkbuf(2,4,ico),bA=mkbuf(3,3,icA),
      bB=mkbuf(4,3,icB);
gl.disable(gl.DEPTH_TEST);gl.enable(gl.BLEND);
gl.blendFunc(gl.ONE,gl.ONE_MINUS_SRC_ALPHA);
// camera
let cx=0,cy=0,cz=0;for(let i=0;i<N;i++){cx+=pos[3*i];cy+=pos[3*i+1];
cz+=pos[3*i+2];}cx/=N;cy/=N;cz/=N;
let yaw=0.5,pitch=-0.4,dist=6,panx=0,pany=0;
let drag=false,panm=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;panm=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>{drag=false;resort();draw();};
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
lx=e.clientX;ly=e.clientY;
if(panm){panx+=dx*dist/500;pany+=dy*dist/500;}else{yaw+=dx*.005;
pitch+=dy*.005;}draw();};
onwheel=e=>{dist*=Math.exp(e.deltaY*.001);resort();draw();};
function viewRT(){
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),
       cp=Math.cos(pitch);
 // R = Rx(pitch) Ry(yaw); camera at distance `dist` behind the center
 const R=[cyw,sy*sp,sy*cp, 0,cp,-sp, -sy,cyw*sp,cyw*cp]; // column-major
 const T=[panx-(R[0]*cx+R[3]*cy+R[6]*cz),
          pany-(R[1]*cx+R[4]*cy+R[7]*cz),
          dist-(R[2]*cx+R[5]*cy+R[8]*cz)];
 return [R,T];
}
const ord=new Uint32Array(N), key=new Float32Array(N);
function resort(){
 const [R,T]=viewRT();
 for(let i=0;i<N;i++){
  key[i]=R[2]*pos[3*i]+R[5]*pos[3*i+1]+R[8]*pos[3*i+2]+T[2];ord[i]=i;}
 const a=Array.from(ord);a.sort((x,y)=>key[y]-key[x]); // back to front
 for(let k=0;k<N;k++){const i=a[k];
  ipos[3*k]=pos[3*i];ipos[3*k+1]=pos[3*i+1];ipos[3*k+2]=pos[3*i+2];
  ico[4*k]=colop[4*i];ico[4*k+1]=colop[4*i+1];ico[4*k+2]=colop[4*i+2];
  ico[4*k+3]=colop[4*i+3];
  icA[3*k]=cov[6*i];icA[3*k+1]=cov[6*i+1];icA[3*k+2]=cov[6*i+2];
  icB[3*k]=cov[6*i+3];icB[3*k+1]=cov[6*i+4];icB[3*k+2]=cov[6*i+5];}
 for(const [b,arr] of [[bpos,ipos],[bco,ico],[bA,icA],[bB,icB]]){
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferSubData(gl.ARRAY_BUFFER,0,arr);}
}
function draw(){
 gl.clearColor(0.043,0.043,0.07,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const [R,T]=viewRT();
 gl.uniformMatrix3fv(uR,false,new Float32Array(R));
 gl.uniform3fv(uT,new Float32Array(T));
 gl.uniform2f(ures,W,H);gl.uniform1f(ufl,0.9*Math.min(W,H));
 gl.drawArraysInstanced(gl.TRIANGLE_STRIP,0,4,N);
}
resort();draw();
</script></body></html>
"""


def export_splat_viewer(path: str, xyz: np.ndarray, rgb: np.ndarray,
                        opacity: np.ndarray, scales3: np.ndarray,
                        rot_xyzw: np.ndarray,
                        max_points: int = 150000) -> str:
    """Write a WebGL2 sort-and-blend splat viewer rendering the ACTUAL
    anisotropic gaussians (EWA projection + exp falloff + back-to-front
    blending) — functional parity with the reference's OpenGL GLSL viewer
    (src/gui/gl_render/render_ogl.py:1-137, shaders/gau_vert.glsl).

    xyz (N,3); rgb (N,3) in [0,1]; opacity (N,) post-sigmoid;
    scales3 (N,3) post-exp; rot_xyzw (N,4) unit quaternions."""
    n = xyz.shape[0]
    if n > max_points:
        sel = np.random.RandomState(0).choice(n, max_points, replace=False)
        xyz, rgb, opacity = xyz[sel], rgb[sel], opacity[sel]
        scales3, rot_xyzw = scales3[sel], rot_xyzw[sel]
        n = max_points

    # precompute packed upper-tri 3D covariance (R S S^T R^T), world frame
    x, y, z, w = (rot_xyzw[:, 0], rot_xyzw[:, 1], rot_xyzw[:, 2],
                  rot_xyzw[:, 3])
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    if scales3.ndim == 1:
        scales3 = np.repeat(scales3[:, None], 3, axis=1)
    M = R * scales3[:, None, :]               # R @ diag(s)
    S = M @ M.transpose(0, 2, 1)              # (N,3,3)
    cov6 = np.stack([S[:, 0, 0], S[:, 0, 1], S[:, 0, 2],
                     S[:, 1, 1], S[:, 1, 2], S[:, 2, 2]], -1)

    blob = np.concatenate([
        np.asarray(xyz, np.float32).reshape(-1),
        np.concatenate([np.clip(np.asarray(rgb, np.float32), 0, 1),
                        np.clip(np.asarray(opacity, np.float32), 0, 1)
                        [:, None]], -1).reshape(-1),
        np.asarray(cov6, np.float32).reshape(-1),
    ]).tobytes()
    html = (_SPLAT_TEMPLATE
            .replace("__NPTS__", str(n))
            .replace("__DATA__", base64.b64encode(blob).decode("ascii")))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def export_viewer_from_map(path: str, gmap) -> str:
    """Export the port's GaussianMap: the WebGL2 splat renderer, plus the
    2D-canvas point view as <name>_points.html."""
    from ..ops import sh as sh_utils
    from ..slam import gaussian_map as gm

    p = gmap.params
    alive = gmap.aux.alive.cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()[alive]
    xyz = host(p.xyz)
    rgb = host(sh_utils.sh_to_rgb(p.f_dc[:, 0]))
    scales3 = host(gm.get_scaling(p))
    opacity = host(gm.get_opacity(p))
    rot = host(gm.get_rotation_xyzw(p))
    base, ext = os.path.splitext(path)
    export_viewer(base + "_points" + ext, xyz, rgb, scales3.mean(-1))
    return export_splat_viewer(path, xyz, rgb, opacity, scales3, rot)
