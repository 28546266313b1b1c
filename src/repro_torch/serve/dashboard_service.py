"""Live analytics HTTP service — the paper's §4 web-dashboard criterion as a
zero-dependency threaded server over any storage URL.

``python -m repro_torch.serve.dashboard_service --storage remote://h1:4000,h2:4000``
serves a browser dashboard for every study behind the URL (inmemory object,
``remote://`` server, or comma-sharded server pool), with five live views
(optimization history, contour, slice, Pareto front, learning curves), fANOVA
parameter importances, a cluster metrics page, and a Prometheus-style
``/metrics`` endpoint.

The refresh path is revision-gated end to end: the browser polls
``/api/study/<name>/delta?since_rev=R&since_num=N``; the service answers with
one ``get_trials_revision`` RPC (through the same :class:`RevisionPoller` the
``--live`` terminal dashboard uses) and, when the revision is unchanged,
returns ``{"idle": true}`` without touching the trial data at all — an idle
study costs zero storage refetches (pinned by the
``records.*.refresh.noop/fetch`` telemetry counters in
``tests/test_torch_dashboard_service.py``).  An active study ships only the rows
with ``number > N``, and the rows of the trials that the last answer listed
as ``pending`` (unfinished at or below N: concurrent workers finish out of
order) and the page sends back as ``&pending=a,b``, so each row ships once.
The columnar stores refresh watermark-incrementally and the row walk starts
at a ``searchsorted`` offset, so the poll is O(new trials), not O(study).

Endpoints
---------

====================================  =======================================
``GET /``                             study index page (HTML)
``GET /study/<name>``                 live study dashboard (HTML + inline JS)
``GET /cluster``                      per-shard server metrics page (HTML)
``GET /metrics``                      Prometheus text format (telemetry)
``GET /api/studies``                  JSON study list
``GET /api/study/<name>/delta``       revision-gated incremental rows
``GET /api/study/<name>/views``       all five views (version-cached)
``GET /api/study/<name>/importance``  fANOVA + Spearman, per objective
``GET /api/cluster/metrics``          ``get_server_metrics`` fan-out
====================================  =======================================

Auth mirrors the storage server's scoped-token model: ``tokens`` entries are
either plain strings (full access) or ``{"token", "readonly", "studies"}``
dicts.  Every endpoint here is a read, so *read-only* tokens are accepted
everywhere; *study-scoped* tokens are confined to their studies' pages and
APIs and are denied on the global endpoints (``/metrics``, ``/cluster``,
``/api/studies``, ``/api/cluster/metrics``).
"""

from __future__ import annotations

import argparse
import html
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, unquote, urlparse

from ..core import telemetry
from ..core.analytics import RevisionPoller, StudyAnalytics, jsonable
from ..core.storage import get_storage
from ..core.study import load_study

__all__ = ["DashboardService", "main"]


# ---------------------------------------------------------------------------
# auth scopes (mirrors storage/server.py's token model, reads only)
# ---------------------------------------------------------------------------


class _Scope:
    __slots__ = ("studies",)

    def __init__(self, studies: "frozenset[str] | None" = None):
        # None = all studies; a frozenset of study *names* bounds the token.
        # `readonly` needs no field: the service has no write endpoint, so a
        # read-only token is as powerful here as a full one.
        self.studies = studies

    def allows_study(self, name: str) -> bool:
        return self.studies is None or name in self.studies

    @property
    def global_ok(self) -> bool:
        return self.studies is None


def _normalize_tokens(tokens) -> "dict[str, _Scope]":
    out: dict[str, _Scope] = {}
    for ent in tokens or []:
        if isinstance(ent, str):
            out[ent] = _Scope()
            continue
        studies = ent.get("studies")
        out[ent["token"]] = _Scope(
            frozenset(str(s) for s in studies) if studies is not None else None
        )
    return out


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------


class _StudyHandle:
    """One study's live state: the Study object, its analytics engine, and
    the shared revision poller."""

    __slots__ = ("study", "analytics", "poller", "lock")

    def __init__(self, study):
        self.study = study
        self.analytics = StudyAnalytics(study)
        self.poller = RevisionPoller(study._storage, study._study_id)
        self.lock = threading.Lock()


class DashboardService:
    """Threaded HTTP dashboard over one storage URL.  ``port=0`` binds an
    ephemeral port (read it back from :attr:`port` after :meth:`start`)."""

    def __init__(
        self,
        storage: "str | Any" = None,
        host: str = "127.0.0.1",
        port: int = 0,
        tokens: "list | None" = None,
    ):
        # cache=True: every study handle shares the incremental CachedStorage
        # proxy, so trial data is fetched once per revision across all views
        self._storage = get_storage(storage, cache=True)
        self._host = host
        self._port = int(port)
        self._scopes = _normalize_tokens(tokens)
        self._handles: dict[str, _StudyHandle] = {}
        self._lock = threading.Lock()
        self._httpd: "ThreadingHTTPServer | None" = None
        self._thread: "threading.Thread | None" = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "DashboardService":
        service = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                service._dispatch(self)

            def log_message(self, fmt, *args):  # quiet by default
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dashboard-service", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    # -- study handles -------------------------------------------------------

    def _handle(self, name: str) -> _StudyHandle:
        with self._lock:
            h = self._handles.get(name)
            if h is None:
                # a viewer never samples: the host engine keeps it off the card
                h = _StudyHandle(load_study(name, self._storage, engine="numpy"))
                self._handles[name] = h
            return h

    # -- request dispatch ----------------------------------------------------

    def _scope_for(self, req) -> "_Scope | None":
        """Resolve the request's token to a scope (None = denied).  With no
        tokens configured, everything is open (full scope)."""
        if not self._scopes:
            return _Scope()
        auth = req.headers.get("Authorization", "")
        tok = auth[7:] if auth.startswith("Bearer ") else None
        if tok is None:
            q = parse_qs(urlparse(req.path).query)
            tok = (q.get("token") or [None])[0]
        return self._scopes.get(tok) if tok else None

    def _dispatch(self, req) -> None:
        telemetry.inc("dashboard.http.requests")
        try:
            parsed = urlparse(req.path)
            path = unquote(parsed.path)
            query = parse_qs(parsed.query)
            scope = self._scope_for(req)
            if scope is None:
                self._send(req, 401, "text/plain", b"unauthorized")
                return
            self._route(req, path, query, scope)
        except BrokenPipeError:
            pass
        except Exception as exc:  # surface, don't kill the handler thread
            try:
                self._send_json(req, 500, {"error": str(exc)})
            except Exception:
                pass

    def _route(self, req, path: str, query: dict, scope: _Scope) -> None:
        m = re.match(r"^/api/study/([^/]+)/(delta|views|importance)$", path)
        if m:
            name = m.group(1)
            if not scope.allows_study(name):
                self._send_json(req, 403, {"error": "token not scoped to study"})
                return
            kind = m.group(2)
            h = self._handle(name)
            if kind == "delta":
                self._send_json(req, 200, self._delta(h, query))
            elif kind == "views":
                with h.lock:
                    self._send_json(req, 200, h.analytics.views())
            else:
                with h.lock:
                    self._send_json(req, 200, h.analytics.importances())
            return

        m = re.match(r"^/study/([^/]+)$", path)
        if m:
            name = m.group(1)
            if not scope.allows_study(name):
                self._send(req, 403, "text/plain", b"token not scoped to study")
                return
            self._send(req, 200, "text/html", _study_page(name).encode())
            return

        # everything below is a global endpoint: study-scoped tokens denied
        if not scope.global_ok:
            self._send(req, 403, "text/plain", b"study-scoped token")
            return

        if path == "/" or path == "/index.html":
            self._send(req, 200, "text/html", self._index_page().encode())
        elif path == "/cluster":
            self._send(req, 200, "text/html", _cluster_page().encode())
        elif path == "/metrics":
            self._send(req, 200, "text/plain; version=0.0.4", self._prometheus().encode())
        elif path == "/api/studies":
            self._send_json(req, 200, self._studies_payload())
        elif path == "/api/cluster/metrics":
            self._send_json(req, 200, self._cluster_metrics())
        else:
            self._send(req, 404, "text/plain", b"not found")

    # -- responses -----------------------------------------------------------

    @staticmethod
    def _send(req, status: int, ctype: str, body: bytes) -> None:
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    @classmethod
    def _send_json(cls, req, status: int, payload: dict) -> None:
        cls._send(
            req, status, "application/json",
            json.dumps(payload, allow_nan=False).encode(),
        )

    # -- endpoint bodies -----------------------------------------------------

    def _delta(self, h: _StudyHandle, query: dict) -> dict:
        since_rev = int((query.get("since_rev") or [-1])[0])
        since_num = int((query.get("since_num") or [-1])[0])
        pending = [int(p) for p in (query.get("pending") or [""])[0].split(",") if p]
        with h.lock:
            h.poller.poll()  # exactly one get_trials_revision RPC
            rev = h.poller.rev
            if rev == since_rev:
                # unchanged study: no trial data is touched at all
                telemetry.inc("dashboard.delta.idle")
                return {"rev": rev, "idle": True}
            telemetry.inc("dashboard.delta.active")
            payload = h.analytics.delta_rows(since_num, pending)
            payload["rev"] = rev
            payload["idle"] = False
            return payload

    def _studies_payload(self) -> dict:
        studies = []
        for s in self._storage.get_all_studies():
            studies.append(
                {
                    "name": s.study_name,
                    "n_trials": int(s.n_trials),
                    "directions": [d.name.lower() for d in s.directions],
                }
            )
        return {"studies": studies}

    def _cluster_metrics(self) -> dict:
        fn = getattr(self._storage, "get_server_metrics", None)
        metrics = None
        if fn is not None:
            try:
                metrics = fn()
            except Exception:
                metrics = None
        # normalize: sharded storage already returns {"shards": [...]}
        if metrics is None:
            shards: list = []
        elif isinstance(metrics, dict) and "shards" in metrics:
            shards = metrics["shards"]
        else:
            shards = [metrics]
        return jsonable({"n_shards": len(shards), "shards": shards})

    def _prometheus(self) -> str:
        """Telemetry registry as Prometheus text exposition format."""

        def sanitize(name: str) -> str:
            return re.sub(r"[^a-zA-Z0-9_]", "_", name)

        snap = telemetry.snapshot()
        lines = []
        for name, v in snap.get("counters", {}).items():
            metric = f"repro_{sanitize(name)}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {v}")
        for name, v in snap.get("gauges", {}).items():
            metric = f"repro_{sanitize(name)}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {v}")
        for name, s in snap.get("histograms", {}).items():
            metric = f"repro_{sanitize(name)}_seconds"
            lines.append(f"# TYPE {metric} summary")
            for q in ("p50", "p95", "p99"):
                lines.append(f'{metric}{{quantile="{q[1:]}"}} {s[q]}')
            lines.append(f"{metric}_sum {s['sum']}")
            lines.append(f"{metric}_count {s['count']}")
        return "\n".join(lines) + "\n"

    def _index_page(self) -> str:
        rows = []
        for s in self._storage.get_all_studies():
            name = html.escape(s.study_name)
            dirs = ", ".join(d.name.lower() for d in s.directions)
            rows.append(
                f'<tr><td><a href="/study/{name}">{name}</a></td>'
                f"<td>{dirs}</td><td>{s.n_trials}</td></tr>"
            )
        body = (
            "<h1>studies</h1>"
            '<table><tr><th>study</th><th>directions</th><th>trials</th></tr>'
            f'{"".join(rows) or "<tr><td colspan=3>none yet</td></tr>"}</table>'
            '<p><a href="/cluster">cluster metrics</a> · '
            '<a href="/metrics">prometheus</a></p>'
        )
        return _PAGE.format(title="studies", body=body, script="")


# ---------------------------------------------------------------------------
# HTML (self-contained, inline JS, repo palette)
# ---------------------------------------------------------------------------

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 16px; color: #222; }}
h1, h2 {{ font-weight: 600; }} h1 {{ font-size: 20px; }} h2 {{ font-size: 15px; }}
table {{ border-collapse: collapse; font-size: 12px; }}
td, th {{ border: 1px solid #ccc; padding: 3px 8px; text-align: left; }}
svg {{ background: #fafafa; border: 1px solid #ddd; }}
.grid {{ display: flex; flex-wrap: wrap; gap: 16px; }}
.card {{ min-width: 340px; }}
#status {{ color: #666; font-size: 12px; }}
a {{ color: #3b6fb6; }}
</style></head><body>{body}<script>{script}</script></body></html>
"""

_STUDY_JS = r"""
'use strict';
const NAME = document.body.dataset.study;
const B='#3b6fb6', R='#c0392b', G='#2b8a3e';
let rev = -1, lastNum = -1, pending = [], rows = [], nViews = -1;
const S = (w,h)=>{const s=document.createElementNS('http://www.w3.org/2000/svg','svg');
  s.setAttribute('width',w);s.setAttribute('height',h);return s;};
function el(svg,tag,attrs){const e=document.createElementNS('http://www.w3.org/2000/svg',tag);
  for(const k in attrs)e.setAttribute(k,attrs[k]);svg.appendChild(e);return e;}
function scale(v,lo,hi,a,b){return hi<=lo?(a+b)/2:a+(v-lo)/(hi-lo)*(b-a);}
function extent(a){let lo=Infinity,hi=-Infinity;for(const v of a){if(v==null)continue;
  if(v<lo)lo=v;if(v>hi)hi=v;}return [lo,hi];}
function axes(svg,W,H,P,xlo,xhi,ylo,yhi){
  el(svg,'line',{x1:P,y1:H-P,x2:W-P,y2:H-P,stroke:'#999'});
  el(svg,'line',{x1:P,y1:P,x2:P,y2:H-P,stroke:'#999'});
  const t=(x,y,s,anc)=>{const e=el(svg,'text',{x:x,y:y,'font-size':9,fill:'#666',
    'text-anchor':anc||'middle'});e.textContent=s;};
  t(P,H-P+12,xlo.toPrecision(3));t(W-P,H-P+12,xhi.toPrecision(3));
  t(P-4,H-P,ylo.toPrecision(3),'end');t(P-4,P+8,yhi.toPrecision(3),'end');}
function drawHistory(div,hist){
  div.innerHTML='';const W=420,H=240,P=36;
  hist.forEach((h,k)=>{
    const svg=S(W,H);div.appendChild(svg);
    const n=h.numbers,v=h.values,b=h.best;
    if(!n.length){return;}
    const [xlo,xhi]=extent(n),[ylo,yhi]=extent(v.concat(b));
    axes(svg,W,H,P,xlo,xhi,ylo,yhi);
    for(let i=0;i<n.length;i++){
      el(svg,'circle',{cx:scale(n[i],xlo,xhi,P,W-P),cy:scale(v[i],ylo,yhi,H-P,P),
        r:2,fill:B,'fill-opacity':0.6});}
    const pts=n.map((x,i)=>scale(x,xlo,xhi,P,W-P)+','+scale(b[i],ylo,yhi,H-P,P)).join(' ');
    el(svg,'polyline',{points:pts,fill:'none',stroke:R,'stroke-width':1.5});
    const lbl=el(svg,'text',{x:W-P,y:P-4,'font-size':10,'text-anchor':'end',fill:'#666'});
    lbl.textContent='objective '+k;});
}
function drawContour(div,c){
  div.innerHTML='';if(!c){div.textContent='needs two parameters';return;}
  const W=420,H=280,P=40,svg=S(W,H);div.appendChild(svg);
  const nx=c.x_edges.length-1,ny=c.y_edges.length-1;
  let lo=Infinity,hi=-Infinity;
  for(const row of c.grid)for(const z of row){if(z==null)continue;if(z<lo)lo=z;if(z>hi)hi=z;}
  for(let r=0;r<ny;r++)for(let q=0;q<nx;q++){
    const z=c.grid[r][q];if(z==null)continue;
    const f=hi<=lo?0.5:(z-lo)/(hi-lo);
    const col='rgb('+Math.round(60+180*f)+','+Math.round(110-60*f)+','+Math.round(200-160*f)+')';
    el(svg,'rect',{x:P+q*(W-2*P)/nx,y:H-P-(r+1)*(H-2*P)/ny,
      width:(W-2*P)/nx+0.5,height:(H-2*P)/ny+0.5,fill:col});}
  axes(svg,W,H,P,c.x_edges[0],c.x_edges[nx],c.y_edges[0],c.y_edges[ny]);
  const t=el(svg,'text',{x:W/2,y:12,'font-size':10,'text-anchor':'middle',fill:'#666'});
  t.textContent=c.x_param+' vs '+c.y_param;}
function drawSlices(div,slices){
  div.innerHTML='';
  for(const s of slices.slice(0,4)){
    const W=220,H=170,P=30,svg=S(W,H);div.appendChild(svg);
    if(!s.x.length)continue;
    const [xlo,xhi]=extent(s.x),[ylo,yhi]=extent(s.z);
    axes(svg,W,H,P,xlo,xhi,ylo,yhi);
    for(let i=0;i<s.x.length;i++)
      el(svg,'circle',{cx:scale(s.x[i],xlo,xhi,P,W-P),cy:scale(s.z[i],ylo,yhi,H-P,P),
        r:1.7,fill:B,'fill-opacity':0.5});
    const bs=s.bins;
    if(bs.centers.length>1){
      const band=bs.centers.map((c,i)=>scale(c,xlo,xhi,P,W-P)+','+scale(bs.hi[i],ylo,yhi,H-P,P))
        .concat(bs.centers.slice().reverse().map((c,i)=>{const j=bs.centers.length-1-i;
          return scale(c,xlo,xhi,P,W-P)+','+scale(bs.lo[j],ylo,yhi,H-P,P);})).join(' ');
      el(svg,'polygon',{points:band,fill:G,'fill-opacity':0.15});
      el(svg,'polyline',{points:bs.centers.map((c,i)=>scale(c,xlo,xhi,P,W-P)+','+
        scale(bs.med[i],ylo,yhi,H-P,P)).join(' '),fill:'none',stroke:G,'stroke-width':1.5});}
    const t=el(svg,'text',{x:W/2,y:11,'font-size':10,'text-anchor':'middle',fill:'#666'});
    t.textContent=s.param;}}
function drawPareto(div,p){
  div.innerHTML='';if(!p){div.textContent='2-objective studies only';return;}
  const W=300,H=240,P=36,svg=S(W,H);div.appendChild(svg);
  if(!p.numbers.length)return;
  const xs=p.values.map(v=>v[0]),ys=p.values.map(v=>v[1]);
  const [xlo,xhi]=extent(xs),[ylo,yhi]=extent(ys);
  axes(svg,W,H,P,xlo,xhi,ylo,yhi);
  const front=new Set(p.front_numbers);
  for(let i=0;i<xs.length;i++){
    const f=front.has(p.numbers[i]);
    el(svg,'circle',{cx:scale(xs[i],xlo,xhi,P,W-P),cy:scale(ys[i],ylo,yhi,H-P,P),
      r:f?3:2,fill:f?R:B,'fill-opacity':f?0.95:0.45});}}
function drawCurves(div,curves){
  div.innerHTML='';
  for(const obj of curves.objectives){
    const W=300,H=200,P=30,svg=S(W,H);div.appendChild(svg);
    const steps=obj.steps,M=obj.matrix;
    if(!steps.length||!M.length)continue;
    let lo=Infinity,hi=-Infinity;
    for(const row of M)for(const v of row){if(v==null)continue;if(v<lo)lo=v;if(v>hi)hi=v;}
    axes(svg,W,H,P,steps[0],steps[steps.length-1],lo,hi);
    for(const row of M){
      const pts=[];
      for(let i=0;i<steps.length;i++)if(row[i]!=null)
        pts.push(scale(steps[i],steps[0],steps[steps.length-1],P,W-P)+','+
          scale(row[i],lo,hi,H-P,P));
      if(pts.length>1)el(svg,'polyline',{points:pts.join(' '),fill:'none',
        stroke:B,'stroke-opacity':0.45,'stroke-width':1});}}}
function drawImportance(div,imp){
  div.innerHTML='';
  for(const k in imp.fanova){
    const d=imp.fanova[k];const names=Object.keys(d);
    if(!names.length)continue;
    const h=document.createElement('div');
    h.innerHTML='<b style="font-size:11px">objective '+k+' (fANOVA)</b>';
    div.appendChild(h);
    for(const n of names){
      const row=document.createElement('div');
      row.style.cssText='display:flex;align-items:center;font-size:11px;gap:6px';
      row.innerHTML='<span style="width:110px;text-align:right">'+n+'</span>'+
        '<span style="display:inline-block;height:10px;background:'+B+';width:'+
        Math.max(1,Math.round(d[n]*180))+'px"></span><span>'+d[n].toFixed(3)+'</span>';
      div.appendChild(row);}}}
function renderTable(){
  const t=document.getElementById('trials');
  const last=rows.slice(-25).reverse();
  let h='<tr><th>#</th><th>state</th><th>values</th><th>params</th></tr>';
  for(const r of last)h+='<tr><td>'+r.number+'</td><td>'+r.state+'</td><td>'+
    r.values.map(v=>v==null?'nan':v.toPrecision(5)).join(', ')+'</td><td>'+
    Object.entries(r.params).map(([k,v])=>k+'='+(typeof v==='number'?v.toPrecision(4):v))
      .join(', ')+'</td></tr>';
  t.innerHTML=h;}
async function refreshViews(){
  const v=await (await fetch('/api/study/'+NAME+'/views')).json();
  drawHistory(document.getElementById('history'),v.history);
  drawContour(document.getElementById('contour'),v.contour);
  drawSlices(document.getElementById('slices'),v.slices);
  drawPareto(document.getElementById('pareto'),v.pareto);
  drawCurves(document.getElementById('curves'),v.curves);
  drawImportance(document.getElementById('importance'),v.importance);
  document.getElementById('meta').textContent=
    v.n_finished+' finished ('+Object.entries(v.by_state).map(([k,n])=>k+':'+n).join(' ')+
    ') · directions: '+v.directions.join(', ');}
async function poll(){
  try{
    const d=await (await fetch('/api/study/'+NAME+'/delta?since_rev='+rev+
      '&since_num='+lastNum+(pending.length?'&pending='+pending.join(','):''))).json();
    if(d.idle){document.getElementById('status').textContent=
      'idle @ rev '+d.rev+' · '+new Date().toLocaleTimeString();}
    else{
      rev=d.rev;lastNum=d.last_number;pending=d.pending||[];
      rows=rows.concat(d.rows);renderTable();
      document.getElementById('status').textContent=
        '+'+d.rows.length+' rows @ rev '+d.rev+' · '+new Date().toLocaleTimeString();
      await refreshViews();}
  }catch(e){document.getElementById('status').textContent='poll error: '+e;}
  setTimeout(poll,2000);}
poll();
"""

_CLUSTER_JS = r"""
'use strict';
async function poll(){
  try{
    const m=await (await fetch('/api/cluster/metrics')).json();
    const div=document.getElementById('shards');
    let h='';
    m.shards.forEach((s,i)=>{
      h+='<h2>shard '+i+'</h2><table><tr><th>metric</th><th>value</th></tr>';
      const flat=(obj,pre)=>{for(const k in obj){const v=obj[k];
        if(v&&typeof v==='object'&&!Array.isArray(v))flat(v,pre+k+'.');
        else h+='<tr><td>'+pre+k+'</td><td>'+JSON.stringify(v)+'</td></tr>';}};
      flat(s,'');h+='</table>';});
    div.innerHTML=h||'<p>no server metrics (local storage?)</p>';
    document.getElementById('status').textContent=
      m.n_shards+' shard(s) · '+new Date().toLocaleTimeString();
  }catch(e){document.getElementById('status').textContent='poll error: '+e;}
  setTimeout(poll,3000);}
poll();
"""


def _study_page(name: str) -> str:
    safe = html.escape(name)
    body = (
        f'<h1><a href="/">studies</a> / {safe}</h1>'
        '<p id="meta"></p><p id="status">connecting…</p>'
        '<div class="grid">'
        '<div class="card"><h2>optimization history</h2><div id="history"></div></div>'
        '<div class="card"><h2>contour</h2><div id="contour"></div></div>'
        '<div class="card"><h2>pareto front</h2><div id="pareto"></div></div>'
        '<div class="card"><h2>learning curves</h2><div id="curves"></div></div>'
        '<div class="card"><h2>slices</h2><div id="slices"></div></div>'
        '<div class="card"><h2>importance</h2><div id="importance"></div></div>'
        '</div><h2>recent trials</h2><table id="trials"></table>'
    )
    page = _PAGE.format(title=safe, body=body, script=_STUDY_JS)
    return page.replace("<body>", f'<body data-study="{safe}">')


def _cluster_page() -> str:
    body = (
        '<h1><a href="/">studies</a> / cluster</h1>'
        '<p id="status">connecting…</p><div id="shards"></div>'
    )
    return _PAGE.format(title="cluster", body=body, script=_CLUSTER_JS)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.serve.dashboard_service",
        description="live analytics dashboard over any storage URL",
    )
    ap.add_argument("--storage", required=True, help="storage URL (remote://, sqlite://, …)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--token", action="append", default=None,
                    help="auth token (repeatable; omit for open access)")
    args = ap.parse_args(argv)
    telemetry.enable()
    svc = DashboardService(
        args.storage, host=args.host, port=args.port, tokens=args.token
    ).start()
    print(f"dashboard: {svc.url}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    main()
