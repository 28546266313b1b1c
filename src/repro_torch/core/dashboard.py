"""Static-HTML dashboard (paper §4, Fig. 8) — zero-dependency.

Generates a self-contained HTML file with hand-rolled SVG:

* optimization-history plot (objective value vs trial number + best-so-far),
* intermediate-value learning curves (pruned trials drawn dimmed),
* parallel-coordinates plot of sampled parameters,
* parameter importances,
* the trials table.

Real-time use: re-render on a timer (``watch -n10``) or from a study callback;
the render reads only storage, so it works against a live distributed study.
"""

from __future__ import annotations

import html
import math
from typing import TYPE_CHECKING

from .frozen import StudyDirection, TrialState
from .importance import param_importances

if TYPE_CHECKING:
    from .study import Study

__all__ = ["render_dashboard", "save_dashboard"]

W, H, PAD = 640, 300, 40


def _scale(vs, lo, hi, out_lo, out_hi):
    if hi <= lo:
        return [0.5 * (out_lo + out_hi) for _ in vs]
    return [out_lo + (v - lo) / (hi - lo) * (out_hi - out_lo) for v in vs]


def _poly(points: list[tuple[float, float]], color: str, width: float = 1.5, opacity: float = 1.0) -> str:
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in points)
    return (
        f'<polyline fill="none" stroke="{color}" stroke-width="{width}" '
        f'opacity="{opacity}" points="{pts}"/>'
    )


def _svg(body: str, w: int = W, h: int = H) -> str:
    return (
        f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}" '
        f'style="background:#fff;border:1px solid #ddd">{body}</svg>'
    )


def _axis_frame(w: int = W, h: int = H) -> str:
    return (
        f'<line x1="{PAD}" y1="{h-PAD}" x2="{w-10}" y2="{h-PAD}" stroke="#888"/>'
        f'<line x1="{PAD}" y1="10" x2="{PAD}" y2="{h-PAD}" stroke="#888"/>'
    )


def _history_svg(study: "Study") -> str:
    trials = [
        t for t in study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
        if t.values and math.isfinite(t.values[0])
    ]
    if not trials:
        return _svg('<text x="20" y="40">no completed trials</text>')
    xs = [t.number for t in trials]
    ys = [t.values[0] for t in trials]
    lo, hi = min(ys), max(ys)
    sx = _scale(xs, min(xs), max(xs), PAD, W - 10)
    sy = _scale(ys, lo, hi, H - PAD, 10)
    pts = "".join(
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.5" fill="#3b6fb6"/>' for x, y in zip(sx, sy)
    )
    # best-so-far line (first objective on multi-objective studies)
    best, bests = None, []
    minimize = study.directions[0] == StudyDirection.MINIMIZE
    for y in ys:
        best = y if best is None else (min(best, y) if minimize else max(best, y))
        bests.append(best)
    sb = _scale(bests, lo, hi, H - PAD, 10)
    line = _poly(list(zip(sx, sb)), "#c0392b", 2.0)
    labels = (
        f'<text x="{PAD}" y="{H-10}" font-size="11">trial #</text>'
        f'<text x="5" y="20" font-size="11">value [{lo:.4g}, {hi:.4g}]</text>'
    )
    return _svg(_axis_frame() + pts + line + labels)


def _curves_svg(study: "Study", max_curves: int = 200) -> str:
    trials = [t for t in study.get_trials(deepcopy=False) if t.intermediate_values]
    if not trials:
        return _svg('<text x="20" y="40">no intermediate values reported</text>')
    trials = trials[-max_curves:]
    all_v = [v for t in trials for v in t.intermediate_values.values() if math.isfinite(v)]
    all_s = [s for t in trials for s in t.intermediate_values]
    if not all_v:
        return _svg('<text x="20" y="40">no finite intermediate values</text>')
    lo, hi = min(all_v), max(all_v)
    slo, shi = min(all_s), max(all_s)
    body = [_axis_frame()]
    for t in trials:
        steps = sorted(t.intermediate_values)
        vs = [t.intermediate_values[s] for s in steps]
        sx = _scale(steps, slo, shi, PAD, W - 10)
        sy = _scale(vs, lo, hi, H - PAD, 10)
        if t.state == TrialState.PRUNED:
            body.append(_poly(list(zip(sx, sy)), "#bbb", 1.0, 0.6))
        elif t.state == TrialState.COMPLETE:
            body.append(_poly(list(zip(sx, sy)), "#2b8a3e", 1.3, 0.9))
        else:
            body.append(_poly(list(zip(sx, sy)), "#e67e22", 1.3, 0.9))
    body.append(f'<text x="{PAD}" y="{H-10}" font-size="11">step</text>')
    return _svg("".join(body))


def _parallel_svg(study: "Study") -> str:
    trials = [
        t for t in study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
        if t.values and math.isfinite(t.values[0])
    ]
    if len(trials) < 2:
        return _svg('<text x="20" y="40">need >= 2 completed trials</text>')
    names = sorted({n for t in trials for n in t.params})
    axes = names + ["value"]
    n_ax = len(axes)
    xs = _scale(list(range(n_ax)), 0, n_ax - 1, PAD, W - 20)

    cols: dict[str, list[float]] = {}
    for name in names:
        vals = []
        for t in trials:
            if name in t.params:
                vals.append(t.distributions[name].to_internal_repr(t.params[name]))
        cols[name] = vals
    values = [t.values[0] for t in trials]
    vlo, vhi = min(values), max(values)

    body = []
    for i, ax in enumerate(axes):
        body.append(f'<line x1="{xs[i]:.0f}" y1="15" x2="{xs[i]:.0f}" y2="{H-25}" stroke="#999"/>')
        body.append(
            f'<text x="{xs[i]:.0f}" y="{H-8}" font-size="9" text-anchor="middle">{html.escape(ax[:14])}</text>'
        )
    for t, v in zip(trials, values):
        pts = []
        for i, name in enumerate(names):
            if name not in t.params:
                continue
            col = cols[name]
            lo, hi = min(col), max(col)
            y = _scale([t.distributions[name].to_internal_repr(t.params[name])], lo, hi, H - 25, 15)[0]
            pts.append((xs[i], y))
        y = _scale([v], vlo, vhi, H - 25, 15)[0]
        pts.append((xs[-1], y))
        # color by objective (first one on MO studies): blue (good) to red (bad)
        q = 0.0 if vhi <= vlo else (v - vlo) / (vhi - vlo)
        if study.directions[0] == StudyDirection.MAXIMIZE:
            q = 1 - q
        color = f"rgb({int(60+180*q)},{int(110-60*q)},{int(200-160*q)})"
        body.append(_poly(pts, color, 1.0, 0.55))
    return _svg("".join(body))


def _importance_svg(study: "Study") -> str:
    try:
        imps = param_importances(study)
    except Exception:
        imps = {}
    # MO studies return per-objective dicts keyed by objective index
    groups = imps if imps and isinstance(next(iter(imps.values()), None), dict) else {None: imps}
    body = []
    y = 20
    for obj, grp in groups.items():
        if not grp:
            continue
        if obj is not None:
            body.append(f'<text x="20" y="{y}" font-size="10" font-weight="bold">objective {obj}</text>')
            y += 16
        for name, v in list(grp.items())[:12]:
            w = v * (W - 180)
            body.append(f'<rect x="150" y="{y-10}" width="{max(w,1):.0f}" height="12" fill="#3b6fb6"/>')
            body.append(f'<text x="145" y="{y}" font-size="10" text-anchor="end">{html.escape(name[:20])}</text>')
            body.append(f'<text x="{155+w:.0f}" y="{y}" font-size="10">{v:.2f}</text>')
            y += 20
    if not body:
        return _svg('<text x="20" y="40">importances unavailable</text>')
    return _svg("".join(body), W, max(y + 10, 80))


def _table(study: "Study", limit: int = 100) -> str:
    rows = study.trials_dataframe()[-limit:]
    if not rows:
        return "<p>no trials</p>"
    cols = sorted({k for r in rows for k in r})
    head = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
    body = []
    for r in rows:
        tds = "".join(f"<td>{html.escape(str(r.get(c, '')))[:24]}</td>" for c in cols)
        body.append(f"<tr>{tds}</tr>")
    return (
        '<table border="1" cellspacing="0" cellpadding="3" style="font-size:11px">'
        f"<tr>{head}</tr>{''.join(body)}</table>"
    )


def _pareto_svg(study: "Study") -> str:
    """Objective-space scatter for 2-objective studies: completed trials in
    grey, the engine's Pareto front (``Study.pareto_front``) highlighted."""
    values, numbers = study.pareto_front()
    trials = [
        t for t in study.get_trials(deepcopy=False, states=(TrialState.COMPLETE,))
        if t.values and len(t.values) == 2 and all(math.isfinite(v) for v in t.values)
    ]
    if not trials:
        return _svg('<text x="20" y="40">no completed trials</text>')
    xs = [t.values[0] for t in trials]
    ys = [t.values[1] for t in trials]
    sx = _scale(xs, min(xs), max(xs), PAD, W - 10)
    sy = _scale(ys, min(ys), max(ys), H - PAD, 10)
    front = set(numbers.tolist())
    pts = "".join(
        f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{3.5 if t.number in front else 2.0}" '
        f'fill="{"#c0392b" if t.number in front else "#b8c4d0"}"/>'
        for t, x, y in zip(trials, sx, sy)
    )
    labels = (
        f'<text x="{PAD}" y="{H-10}" font-size="11">objective 0</text>'
        f'<text x="5" y="20" font-size="11">objective 1</text>'
        f'<text x="{W-180}" y="20" font-size="11" fill="#c0392b">'
        f"Pareto front ({len(front)} trials)</text>"
    )
    return _svg(_axis_frame() + pts + labels)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"


def _throughput_svg(samples: "list[float]", w: int = 320, h: int = 80) -> str:
    """Sparkline of trial throughput (finished trials/s per poll tick)."""
    if not samples:
        return _svg('<text x="10" y="20" font-size="10">no samples yet</text>', w, h)
    hi = max(max(samples), 1e-9)
    sx = _scale(list(range(len(samples))), 0, max(len(samples) - 1, 1), 5, w - 5)
    sy = _scale(samples, 0.0, hi, h - 15, 5)
    line = _poly(list(zip(sx, sy)), "#2b8a3e", 1.5)
    area = ""
    if len(samples) >= 2:
        pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(sx, sy))
        area = (
            f'<polygon fill="#2b8a3e" opacity="0.15" points="'
            f'{sx[0]:.1f},{h-15} {pts} {sx[-1]:.1f},{h-15}"/>'
        )
    label = (
        f'<text x="5" y="{h-4}" font-size="9">trials/s &middot; '
        f"now {samples[-1]:.2f} &middot; peak {hi:.2f}</text>"
    )
    return _svg(area + line + label, w, h)


def _metrics_panel_html(metrics: "dict | None") -> str:
    """Server-side telemetry panel from a ``get_server_metrics`` payload."""
    if not metrics:
        return "<p>server metrics unavailable (storage has no metrics RPC)</p>"
    up = metrics.get("uptime_s", 0.0)
    summary = (
        f"uptime {up:.0f}s &middot; "
        f"connections {metrics.get('active_connections', 0)} active &middot; "
        f"frames {metrics.get('frames_in', 0)} in / {metrics.get('frames_out', 0)} out &middot; "
        f"{_fmt_bytes(metrics.get('bytes_in', 0))} in / {_fmt_bytes(metrics.get('bytes_out', 0))} out &middot; "
        f"spec cache {metrics.get('spec_cache_hits', 0)} hits"
    )
    methods = metrics.get("methods", {})
    if not methods:
        return f"<p>{summary}</p><p>no RPCs served yet</p>"
    head = (
        "<tr><th>method</th><th>calls</th><th>errors</th><th>bytes out</th>"
        "<th>p50 ms</th><th>p95 ms</th><th>p99 ms</th><th>max ms</th></tr>"
    )
    rows = []
    for name in sorted(methods, key=lambda m: -methods[m].get("calls", 0)):
        m = methods[name]
        rows.append(
            f"<tr><td>{html.escape(str(name))}</td><td>{m.get('calls', 0)}</td>"
            f"<td>{m.get('errors', 0)}</td><td>{_fmt_bytes(m.get('bytes_out', 0))}</td>"
            f"<td>{m.get('p50', 0.0) * 1e3:.2f}</td><td>{m.get('p95', 0.0) * 1e3:.2f}</td>"
            f"<td>{m.get('p99', 0.0) * 1e3:.2f}</td><td>{m.get('max', 0.0) * 1e3:.2f}</td></tr>"
        )
    return (
        f"<p>{summary}</p>"
        '<table border="1" cellspacing="0" cellpadding="3" style="font-size:11px">'
        f"{head}{''.join(rows)}</table>"
    )


def render_dashboard(
    study: "Study",
    server_metrics: "dict | None" = None,
    throughput: "list[float] | None" = None,
) -> str:
    n_by_state = {}
    for t in study.get_trials(deepcopy=False):
        n_by_state[t.state.name] = n_by_state.get(t.state.name, 0) + 1
    directions = study.directions
    if len(directions) == 1:
        try:
            best = f"{study.best_value:.6g} (trial {study.best_trial.number})"
        except ValueError:
            best = "n/a"
    else:
        best = f"{len(study.pareto_front()[1])} Pareto-optimal trials"
    summary = ", ".join(f"{k}: {v}" for k, v in sorted(n_by_state.items()))
    dir_str = ", ".join(d.name.lower() for d in directions)
    pareto_section = (
        f"<h2>Pareto front (objective space)</h2>{_pareto_svg(study)}"
        if len(directions) == 2 else ""
    )
    live_section = ""
    if server_metrics is not None or throughput is not None:
        spark = _throughput_svg(throughput or [])
        live_section = (
            f"<h2>Live server metrics</h2>{spark}"
            f"{_metrics_panel_html(server_metrics)}"
        )
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(study.study_name)}</title>
<style>body{{font-family:sans-serif;margin:20px}} h2{{margin-top:28px}}</style></head>
<body>
<h1>Study: {html.escape(study.study_name)}</h1>
<p>direction: {dir_str} &middot; trials: {summary} &middot; best: {best}</p>
{live_section}
{pareto_section}
<h2>Optimization history</h2>{_history_svg(study)}
<h2>Learning curves (intermediate values)</h2>{_curves_svg(study)}
<h2>Parallel coordinates</h2>{_parallel_svg(study)}
<h2>Parameter importances</h2>{_importance_svg(study)}
<h2>Trials</h2>{_table(study)}
</body></html>"""


def save_dashboard(study: "Study", path: str) -> str:
    htm = render_dashboard(study)
    with open(path, "w") as f:
        f.write(htm)
    return path


def main(argv: "list[str] | None" = None) -> None:
    """Render a dashboard for any storage URL — including a *live* remote
    study being optimized by a worker fleet:

        python -m repro_torch.core.dashboard remote://host:9000 my-study out.html --watch 10
    """
    import argparse
    import time

    from .storage import get_storage
    from .study import load_study

    ap = argparse.ArgumentParser(description="render the study dashboard to HTML")
    ap.add_argument("storage", help="storage URL (sqlite:///, journal://, remote://)")
    ap.add_argument("study_name")
    ap.add_argument("out", help="output HTML path")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="re-render every N seconds (0 = render once)")
    ap.add_argument("--live", action="store_true",
                    help="add the live panel: server metrics (when the storage"
                         " exposes get_server_metrics) + throughput sparkline;"
                         " polling is revision-gated, so idle ticks cost one"
                         " counter RPC and skip the re-render")
    ap.add_argument("--ticks", type=int, default=0, metavar="N",
                    help="with --watch: stop after N polls (0 = forever);"
                         " used by headless smoke tests")
    args = ap.parse_args(argv)

    # cache=True: render_dashboard reads the trial list several times per
    # tick, and --watch re-renders forever — fetch each finished trial once
    storage = get_storage(args.storage, cache=True)
    # a viewer never samples: the host engine keeps it off the card
    study = load_study(args.study_name, storage, engine="numpy")
    sid = study._study_id

    def server_metrics():
        fn = getattr(storage, "get_server_metrics", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    def n_finished():
        return sum(
            t.state.is_finished() for t in study.get_trials(deepcopy=False)
        )

    # one revision-gated poll loop, shared with the HTTP analytics service
    from .analytics import RevisionPoller

    poller = RevisionPoller(storage, sid)
    throughput: list[float] = []
    last_n, last_t = n_finished(), time.monotonic()
    tick = 0
    while True:
        tick += 1
        changed = poller.poll()
        if args.live:
            now = time.monotonic()
            n = n_finished() if changed else last_n
            dt = max(now - last_t, 1e-9)
            throughput.append((n - last_n) / dt if tick > 1 else 0.0)
            throughput = throughput[-120:]
            last_n, last_t = n, now
        if changed or tick == 1:
            htm = render_dashboard(
                study,
                server_metrics=server_metrics() if args.live else None,
                throughput=throughput if args.live else None,
            )
            with open(args.out, "w") as f:
                f.write(htm)
            n = len(study.get_trials(deepcopy=False))  # cache-local, no extra RPC
            print(f"rendered {n} trials -> {args.out}", flush=True)
        if args.watch <= 0 or (args.ticks and tick >= args.ticks):
            break
        time.sleep(args.watch)


if __name__ == "__main__":
    main()
