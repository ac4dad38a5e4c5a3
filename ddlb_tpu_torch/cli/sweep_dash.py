"""Live sweep dashboard: tail the ``DDLB_TPU_LIVE`` stream and render it.

The port's counterpart of the JAX package's ``scripts/sweep_dash.py``
(the same frames). Point a sweep at a stream with
``DDLB_TPU_LIVE=<file>`` and run this against the same file from another
terminal: a read-only tail of an append-only file, so it cannot perturb
the timings it shows. From the folded state
(``observatory/live.fold``): the sweep's progress (rows done of the
total, errors), the workers (the JAX package's pool; none for the port's
in-process runner), the row in flight and its phase, the recent rows
with the rolling median ``roofline_frac`` and overlap fraction, the
per-rank skew lanes, and the serving panel (the latest TTFT percentiles,
goodput and attainment, and the queue-depth sparkline of the
``serving_tick`` events). Event kinds this build does not know are
counted and shown as a note.

Renderers: the curses TUI (default on a terminal; ``q`` quit, ``r``
reload, ``h`` an HTML snapshot next to the stream), plain text
(``--once`` or piped output) and a static HTML snapshot (``--html OUT``).

    python -m ddlb_tpu_torch.cli.sweep_dash [LIVE_FILE] [--once] [--html OUT]
        [--interval S] [--follow]
"""

from __future__ import annotations

import html as html_mod
import os
import sys
import time

from ddlb_tpu_torch.observatory import live
from ddlb_tpu_torch.observatory.regress import finite, median


def _fmt(value, spec="{:.3f}", missing="-"):
    f = finite(value)
    return missing if f is None else spec.format(f)


def _age(seconds):
    if seconds is None or seconds < 0:
        return "-"
    if seconds < 120:
        return f"{seconds:.0f}s"
    return f"{seconds / 60:.1f}m"


def _rolling(state):
    """(median roofline_frac, median overlap_frac, n) over completions."""
    rf = [f["roofline"] for f in state["fracs"] if f.get("roofline") is not None]
    ov = [f["overlap"] for f in state["fracs"] if f.get("overlap") is not None]
    return (
        median(rf) if rf else None,
        median(ov) if ov else None,
        len(state["fracs"]),
    )


#: unicode eighth-block ramp for the text sparkline
_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values, width=40):
    """Queue-depth gauge ring as a block-character sparkline (text
    modes; the HTML snapshot draws the same series as SVG)."""
    if not values:
        return ""
    values = values[-width:]
    hi = max(values)
    if hi <= 0:
        return _SPARK_BLOCKS[0] * len(values)
    return "".join(
        _SPARK_BLOCKS[
            min(len(_SPARK_BLOCKS) - 1, int(v / hi * (len(_SPARK_BLOCKS) - 1)))
        ]
        for v in values
    )


def _serving_lines(state):
    """The serving panel (empty list when no serving events were seen):
    latest SLO summary + the queue-depth sparkline."""
    serving = state.get("serving") or {}
    latest = serving.get("latest")
    depths = serving.get("depths") or []
    progress = serving.get("progress")
    if not latest and not depths:
        return []
    lines = ["", "serving:"]
    if latest:
        lines.append(
            f"  TTFT p50/p95/p99: {_fmt(latest.get('ttft_p50_ms'), '{:.1f}')}"
            f"/{_fmt(latest.get('ttft_p95_ms'), '{:.1f}')}"
            f"/{_fmt(latest.get('ttft_p99_ms'), '{:.1f}')} ms   "
            f"goodput {_fmt(latest.get('goodput_rps'), '{:.2f}')} req/s   "
            f"SLO attainment {_fmt(latest.get('attainment'), '{:.0%}')}"
            f"   [{latest.get('impl')}]"
        )
    if depths:
        head = f"  queue depth (peak {max(depths)}): "
        lines.append(head + _sparkline(depths))
    shards = serving.get("shard_depths")
    if shards:
        # cluster members: per-decode-shard queue gauges;
        # -1 marks a drained shard (dead, not merely idle)
        cells = " ".join(
            f"s{i}:{'drained' if d < 0 else d}"
            for i, d in enumerate(shards)
        )
        lines.append(f"  shard queues: {cells}")
    if progress and progress.get("total"):
        lines.append(
            f"  drain: {progress.get('done')}/{progress.get('total')} done, "
            f"{progress.get('active')} lanes active"
        )
    return lines


def _lane_lines(state):
    """The per-rank skew lane panel (empty when no completed
    row ever named a straggler): per process id, how many rows blamed
    it, its accumulated arrival-skew seconds, the latest frac."""
    lanes = state.get("lanes") or {}
    if not lanes:
        return []
    worst = max(lanes, key=lambda r: lanes[r].get("skew_s") or 0.0)
    lines = ["", "rank lanes (straggler attribution):"]
    for rank in sorted(lanes, key=lambda r: int(r)):
        lane = lanes[rank]
        mark = "  <- worst" if rank == worst and len(lanes) > 1 else ""
        lines.append(
            f"  p{rank}: straggler in {lane.get('straggler_rows', 0)} "
            f"row(s), skew {_fmt(lane.get('skew_s'), '{:.3f}')}s, "
            f"last frac {_fmt(lane.get('last_frac'), '{:.2f}')}{mark}"
        )
    return lines


def _unknown_note(state):
    """One line naming event kinds this dashboard build doesn't know —
    the forward-compat guard (a newer runner sharing the stream must
    degrade loudly, not as a blank frame)."""
    unknown = state.get("unknown") or {}
    if not unknown:
        return ""
    kinds = ", ".join(
        f"{kind} x{count}" for kind, count in sorted(unknown.items())
    )
    return f"note: {sum(unknown.values())} event(s) of unrecognized kind(s): {kinds}"


def render_text(state, width=96):
    """The one frame both text modes (and the curses body) share."""
    totals = state["totals"]
    now = time.time()
    lines = []
    total = totals["total"] or "?"
    lines.append(
        f"sweep: {totals['done']}/{total} rows done"
        f"{'  [sweep complete]' if state.get('sweep_done') else ''}"
    )
    lines.append(
        f"  errors {totals['errors']}  quarantined {totals['quarantined']}"
        f"  parked {totals['parked']}  retries {totals['retries']}"
    )
    rf, ov, n = _rolling(state)
    lines.append(
        f"  rolling pred-vs-measured (n={n}): "
        f"median roofline_frac {_fmt(rf)}  median overlap_frac {_fmt(ov)}"
    )
    lines.append("")
    lines.append("workers:")
    if not state["workers"]:
        lines.append("  (none seen — in-process sweep or no pool events yet)")
    for worker, info in sorted(state["workers"].items(), key=lambda kv: str(kv[0])):
        beat = _age(info.get("beat_age_s"))
        setup = _fmt(info.get("setup_s"), "{:.1f}s")
        lines.append(
            f"  pid {worker}: {info.get('state', '?'):9s} setup {setup:>6s}"
            f"  beat-age {beat:>5s}"
            f"{'  ' + str(info.get('error', ''))[:40] if info.get('state') == 'dead' else ''}"
        )
    lines.append("")
    lines.append("current row:")
    if not state["current"]:
        lines.append("  (idle)")
    for src, cur in state["current"].items():
        since = now - cur["since"] if cur.get("since") else None
        shape = f"{cur.get('m')}x{cur.get('n')}x{cur.get('k')}"
        lines.append(
            f"  {cur.get('impl')} [{cur.get('primitive')} {shape}] — "
            f"{str(cur.get('stage'))[:52]}  ({_age(since)} in row)"
        )
    lines.append("")
    lines.append(
        f"  {'impl':<18} {'median ms':>10} {'pred ms':>9} "
        f"{'roofline':>8} {'overlap':>8}  flags"
    )
    for e in state["recent"]:
        pred = e.get("predicted_s")
        pred_ms = pred * 1e3 if isinstance(pred, (int, float)) else None
        flags = []
        if e.get("error"):
            flags.append("ERROR")
        if e.get("quarantined"):
            flags.append("quarantined")
        if e.get("retries"):
            flags.append(f"retries={e['retries']}")
        if e.get("worker_reused"):
            flags.append("reused")
        lines.append(
            f"  {str(e.get('impl'))[:18]:<18} "
            f"{_fmt(e.get('median_ms')):>10} {_fmt(pred_ms):>9} "
            f"{_fmt(e.get('roofline_frac')):>8} "
            f"{_fmt(e.get('measured_overlap_frac')):>8}  "
            f"{' '.join(flags)}"
        )
    lines.extend(_lane_lines(state))
    lines.extend(_serving_lines(state))
    note = _unknown_note(state)
    if note:
        lines.extend(["", note])
    return "\n".join(line[:width] for line in lines)


# ---------------------------------------------------------------------------
# HTML snapshot (static, self-contained)
# ---------------------------------------------------------------------------

_HTML_HEAD = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>sweep dashboard snapshot</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f4f4f2;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --border: #d9d8d4;
  --status-good: #0ca30c; --status-critical: #d03b3b;
  --status-warning: #fab219;
  --series-1: #2a78d6;
  background: var(--surface-1); color: var(--text-primary);
  font: 14px/1.5 system-ui, sans-serif; padding: 24px; margin: 0;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --border: #3a3a37;
    --series-1: #3987e5;
  }
}
.viz-root h1 { font-size: 18px; margin: 0 0 4px; }
.viz-root h2 { font-size: 15px; margin: 0 0 8px; }
.viz-root .sub { color: var(--text-secondary); margin: 0 0 20px; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin: 0 0 24px; }
.tile { background: var(--surface-2); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 18px; min-width: 120px; }
.tile .v { font-size: 28px; font-weight: 600; }
.tile .l { color: var(--text-secondary); font-size: 12px; }
table { border-collapse: collapse; margin: 0 0 24px; min-width: 60%; }
caption { text-align: left; font-weight: 600; padding: 0 0 6px; }
th { text-align: left; color: var(--text-secondary); font-weight: 500; }
th, td { padding: 4px 14px 4px 0; border-bottom: 1px solid var(--border); }
td.num, th.num { text-align: right; }
.status { white-space: nowrap; }
.status.good { color: var(--status-good); }
.status.bad { color: var(--status-critical); }
.status.warn { color: var(--status-warning); }
.spark { display: block; }
.spark polyline { fill: none; stroke: var(--series-1); stroke-width: 2;
  stroke-linejoin: round; stroke-linecap: round; }
.note { color: var(--text-secondary); margin: 0 0 24px; }
</style></head><body class="viz-root">
"""


def _spark_svg(depths, width=360, height=48, pad=4):
    """The queue-depth gauge ring as one inline SVG polyline (single
    series: the caption names it, the stroke wears the categorical
    slot-1 token, values stay in ink via the caption text)."""
    values = depths[-120:]
    hi = max(max(values), 1)
    n = len(values)
    points = []
    for i, v in enumerate(values):
        x = pad + (width - 2 * pad) * (i / max(n - 1, 1))
        y = height - pad - (height - 2 * pad) * (v / hi)
        points.append(f"{x:.1f},{y:.1f}")
    caption = (
        f"queue depth over the last {n} gauge samples "
        f"(peak {max(values)})"
    )
    return (
        f'<figure class="spark" style="margin:0 0 24px">'
        f'<svg width="{width}" height="{height}" role="img" '
        f'aria-label="{html_mod.escape(caption)}">'
        f'<polyline points="{" ".join(points)}"><title>'
        f"{html_mod.escape(caption)}</title></polyline></svg>"
        f'<figcaption style="color:var(--text-secondary);font-size:12px">'
        f"{html_mod.escape(caption)}</figcaption></figure>"
    )


def render_html(state, source=""):
    """A self-contained static snapshot: a stat-tile row + the worker
    and recent-row tables. No charts — headline numbers are stat tiles
    (the honest form for a handful of KPIs); status is icon + label,
    never color alone; text wears ink tokens, light & dark both ship."""
    esc = html_mod.escape
    totals = state["totals"]
    rf, ov, n = _rolling(state)
    out = [_HTML_HEAD]
    out.append("<h1>Sweep dashboard snapshot</h1>")
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    out.append(
        f'<p class="sub">{esc(source)} &middot; rendered {stamp}'
        f"{' &middot; sweep complete' if state.get('sweep_done') else ''}</p>"
    )
    tiles = [
        (f"{totals['done']}/{totals['total'] or '?'}", "rows done"),
        (str(totals["errors"]), "errors"),
        (str(totals["quarantined"]), "quarantined"),
        (str(totals["parked"]), "parked"),
        (str(totals["retries"]), "retries"),
        (_fmt(rf), f"median roofline frac (n={n})"),
        (_fmt(ov), "median overlap frac"),
    ]
    out.append('<div class="tiles">')
    for value, label in tiles:
        out.append(
            f'<div class="tile"><div class="v">{esc(value)}</div>'
            f'<div class="l">{esc(label)}</div></div>'
        )
    out.append("</div>")

    lanes = state.get("lanes") or {}
    if lanes:
        out.append('<table><caption>Rank lanes (straggler attribution)'
                   "</caption>")
        out.append(
            "<tr><th>rank</th><th class=num>straggler rows</th>"
            "<th class=num>skew (s)</th><th class=num>last frac</th></tr>"
        )
        for rank in sorted(lanes, key=lambda r: int(r)):
            lane = lanes[rank]
            out.append(
                f"<tr><td>p{esc(str(rank))}</td>"
                f"<td class=num>{lane.get('straggler_rows', 0)}</td>"
                f"<td class=num>{_fmt(lane.get('skew_s'), '{:.3f}')}</td>"
                f"<td class=num>{_fmt(lane.get('last_frac'), '{:.2f}')}"
                f"</td></tr>"
            )
        out.append("</table>")

    serving = state.get("serving") or {}
    latest = serving.get("latest")
    depths = serving.get("depths") or []
    if latest or depths:
        out.append("<h2>Serving</h2>")
        if latest:
            s_tiles = [
                (_fmt(latest.get("ttft_p50_ms"), "{:.1f}"), "TTFT p50 (ms)"),
                (_fmt(latest.get("ttft_p95_ms"), "{:.1f}"), "TTFT p95 (ms)"),
                (_fmt(latest.get("ttft_p99_ms"), "{:.1f}"), "TTFT p99 (ms)"),
                (
                    _fmt(latest.get("goodput_rps"), "{:.2f}"),
                    "goodput (req/s in SLO)",
                ),
                (_fmt(latest.get("attainment"), "{:.0%}"), "SLO attainment"),
            ]
            out.append('<div class="tiles">')
            for value, label in s_tiles:
                out.append(
                    f'<div class="tile"><div class="v">{esc(value)}</div>'
                    f'<div class="l">{esc(label)}</div></div>'
                )
            out.append("</div>")
        if depths:
            out.append(_spark_svg(depths))
        shards = serving.get("shard_depths")
        if shards:
            cells = ", ".join(
                f"shard {i}: {'drained' if d < 0 else d}"
                for i, d in enumerate(shards)
            )
            out.append(f'<p class="note">{esc("queues — " + cells)}</p>')
    note = _unknown_note(state)
    if note:
        out.append(f'<p class="note">{esc(note)}</p>')

    out.append('<table><caption>Workers</caption>')
    out.append(
        "<tr><th>pid</th><th>state</th><th class=num>setup</th>"
        "<th class=num>beat age</th><th>note</th></tr>"
    )
    for worker, info in sorted(state["workers"].items(), key=lambda kv: str(kv[0])):
        st = str(info.get("state", "?"))
        cls, icon = {
            "ready": ("good", "&#10003;"),
            "busy": ("good", "&#10003;"),
            "dead": ("bad", "&#10007;"),
        }.get(st, ("warn", "&#8230;"))
        out.append(
            f"<tr><td>{esc(str(worker))}</td>"
            f'<td class="status {cls}">{icon} {esc(st)}</td>'
            f'<td class=num>{_fmt(info.get("setup_s"), "{:.1f}s")}</td>'
            f'<td class=num>{esc(_age(info.get("beat_age_s")))}</td>'
            f'<td>{esc(str(info.get("error", "") or ""))}</td></tr>'
        )
    out.append("</table>")

    out.append('<table><caption>Recent rows</caption>')
    out.append(
        "<tr><th>impl</th><th class=num>median ms</th>"
        "<th class=num>predicted ms</th><th class=num>roofline frac</th>"
        "<th class=num>overlap frac</th><th>status</th></tr>"
    )
    for e in state["recent"]:
        pred = e.get("predicted_s")
        pred_ms = pred * 1e3 if isinstance(pred, (int, float)) else None
        if e.get("error"):
            status = '<td class="status bad">&#10007; error</td>'
        elif e.get("quarantined"):
            status = '<td class="status warn">&#9888; quarantined</td>'
        else:
            status = '<td class="status good">&#10003; measured</td>'
        out.append(
            f"<tr><td>{esc(str(e.get('impl')))}</td>"
            f"<td class=num>{_fmt(e.get('median_ms'))}</td>"
            f"<td class=num>{_fmt(pred_ms)}</td>"
            f"<td class=num>{_fmt(e.get('roofline_frac'))}</td>"
            f"<td class=num>{_fmt(e.get('measured_overlap_frac'))}</td>"
            f"{status}</tr>"
        )
    out.append("</table></body></html>\n")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _load_state(path):
    events, offset = live.read_events(path)
    return live.fold(events), offset


def run_curses(path, interval):  # pragma: no cover - interactive
    """Full-screen tail. q quit; r rebuild from byte 0; h HTML dump."""
    import curses

    def _main(screen):
        curses.curs_set(0)
        screen.nodelay(True)
        state, offset = _load_state(path)
        last = 0.0
        while True:
            key = screen.getch()
            if key in (ord("q"), ord("Q")):
                return
            if key in (ord("r"), ord("R")):
                state, offset = _load_state(path)
            if key in (ord("h"), ord("H")):
                snap = path + ".html"
                with open(snap, "w", encoding="utf-8") as f:
                    f.write(render_html(state, source=path))
            if time.monotonic() - last >= interval:
                events, offset = live.read_events(path, offset)
                state = live.fold(events, state)
                height, width = screen.getmaxyx()
                screen.erase()
                header = f" sweep_dash — {path}  (q quit, r reload, h html)"
                screen.addnstr(0, 0, header, width - 1, curses.A_REVERSE)
                body = render_text(state, width=width - 1)
                for i, line in enumerate(body.splitlines()):
                    if i + 1 >= height:
                        break
                    screen.addnstr(i + 1, 0, line, width - 1)
                screen.refresh()
                last = time.monotonic()
            time.sleep(0.05)

    curses.wrapper(_main)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    once = "--once" in argv
    follow = "--follow" in argv
    argv = [a for a in argv if a not in ("--once", "--follow")]

    def _opt(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"sweep_dash: {flag} needs a value")
            value = argv[i + 1]
            del argv[i: i + 2]
            return value
        return default

    html_out = _opt("--html")
    interval = float(_opt("--interval", "1.0"))
    path = argv[0] if argv else os.environ.get("DDLB_TPU_LIVE", "")
    if not path:
        print(
            "usage: python -m ddlb_tpu_torch.cli.sweep_dash <live_file> [--once] [--html OUT] "
            "[--interval S] [--follow]   (or set DDLB_TPU_LIVE)"
        )
        return 2
    if not os.path.exists(path):
        print(f"sweep_dash: no live stream at {path} — start the sweep "
              f"with DDLB_TPU_LIVE={path}")
        return 1

    if html_out:
        state, _ = _load_state(path)
        with open(html_out, "w", encoding="utf-8") as f:
            f.write(render_html(state, source=path))
        print(f"sweep_dash: HTML snapshot written to {html_out}")
        return 0
    if once or not sys.stdout.isatty():
        state, offset = _load_state(path)
        if once:
            print(render_text(state))
            return 0
        # piped follow mode: append one frame per interval (no ANSI)
        while True:
            print(render_text(state), "\n", flush=True)
            if state.get("sweep_done") and not follow:
                return 0
            time.sleep(interval)
            events, offset = live.read_events(path, offset)
            state = live.fold(events, state)
    try:
        run_curses(path, interval)
    except Exception as exc:  # curses unavailable (no TERM, etc.)
        print(f"sweep_dash: curses unavailable ({exc}); one plain frame:")
        state, _ = _load_state(path)
        print(render_text(state))
    return 0


if __name__ == "__main__":
    sys.exit(main())
