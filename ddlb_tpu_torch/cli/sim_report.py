"""Simulator report: rank collective algorithms on a synthetic world.

The port's counterpart of the JAX package's ``scripts/sim_report.py``
(the same exit codes and ``--json`` documents). For each
collective-bearing family the flat ring, the two-level hierarchical
composition and the striped composition replay on a synthetic world
(``perfmodel/topology.py``) and rank by predicted makespan, before any
card is booked.

    python -m ddlb_tpu_torch.cli.sim_report [--topology SPEC] [--payload-mib N]
        [--families F1,F2] [--json]
    python -m ddlb_tpu_torch.cli.sim_report --degrade CLASS=FACTOR[,...] [...]
    python -m ddlb_tpu_torch.cli.sim_report --validate [--history DIR]

``--topology`` defaults to the preset ``128node1024`` (128 H100 nodes of
eight). An H100 node is one NVLink fabric, one dimension in the spec, so
striping inside a node gains nothing there; a ``cpu:`` world keeps the
JAX package's torus.

``--degrade`` (repeatable) replays the ranking on degraded twins of the
world (``Degradation``: ``class=factor`` pairs over ``ici0``..``dcn``,
0 meaning down): every algorithm's healthy and degraded makespan, the
slowdown and the degraded per-link utilization; a composition routed
through a downed link reports ``unroutable`` and ranks last.

``--validate`` runs the simulator's gates instead: gate 1 (the closed
forms on flat ``h100-sxm`` worlds, every family), gate 2 (the join
against the bank ``--history`` or ``DDLB_TPU_HISTORY`` names) and, when
``DDLB_TPU_CALIB`` names a table, gate 3.

The JAX script's traced member section and ``--compare-members`` replay
members traced by the SPMD interpreter of ``analysis/``, which is not
ported: the ``members`` list of the ``--json`` document is empty.

Exit codes: 0 success; 1 a failed gate (or an empty ranking); 2 usage.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from ddlb_tpu_torch.observatory.store import history_dir as env_history_dir
from ddlb_tpu_torch.perfmodel.topology import (
    parse_degradation,
    resolve_topology,
)
from ddlb_tpu_torch.simulator.engine import replay, summarize
from ddlb_tpu_torch.simulator.frontends import (
    FAMILY_COLLECTIVES,
    SYNTHETIC_ALGOS,
    synthetic_program,
)

DEFAULT_TOPOLOGY = "128node1024"

#: the families the synthetic ranking covers (the explicit-collective ones)
RANKED_FAMILIES = (
    "tp_columnwise",
    "tp_rowwise",
    "dp_allreduce",
    "ep_alltoall",
    "collectives",
)


def json_safe(obj):
    """``obj`` with every non-finite float replaced by None: an
    unroutable replay leaves inf in its busy and utilization fields, and
    strict JSON parsers reject a bare ``Infinity``."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _fmt_s(seconds):
    if seconds is None or not math.isfinite(seconds):
        return "?"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.3f}ms"
    return f"{seconds * 1e6:.3f}us"


def build_degraded_ranking(topology, payload_bytes, families, degradations):
    """The degraded-world ranking: per scenario, per family, every
    synthetic algorithm replayed on the healthy topology AND its
    degraded twin (the scenario-independent healthy replays are cached
    per family/algo). Non-finite degraded makespans (a composition
    routed through a downed link) become ``routable: False`` with a
    None makespan; ``--json`` additionally passes the document through
    ``json_safe`` so the inf/NaN the infinite replay leaves in
    the busy/utilization fields never reach a strict parser."""
    healthy_cache = {}

    def healthy_makespan(family, algo, op):
        if (family, algo) not in healthy_cache:
            healthy_cache[(family, algo)] = replay(
                synthetic_program(algo, op, payload_bytes, topology),
                topology,
            ).makespan_s
        return healthy_cache[(family, algo)]

    scenarios = []
    for degradation in degradations:
        degraded_topo = topology.degraded(degradation)
        blocks = []
        for family in families:
            op = FAMILY_COLLECTIVES[family]
            rows = []
            for algo in SYNTHETIC_ALGOS:
                healthy_s = healthy_makespan(family, algo, op)
                # built against the DEGRADED topology so reroute-capable
                # compositions lay their stripes over surviving axes
                degraded = replay(
                    synthetic_program(
                        algo, op, payload_bytes, degraded_topo
                    ),
                    degraded_topo,
                )
                row = summarize(degraded, degraded_topo)
                routable = math.isfinite(degraded.makespan_s)
                row.update(
                    algo=algo,
                    healthy_s=healthy_s,
                    degraded_s=degraded.makespan_s if routable else None,
                    routable=routable,
                    slowdown=(
                        degraded.makespan_s / healthy_s
                        if routable and healthy_s > 0
                        else None
                    ),
                )
                if not routable:
                    row["makespan_s"] = None
                rows.append(row)
            rows.sort(
                key=lambda r: (
                    not r["routable"],
                    r["degraded_s"] if r["degraded_s"] is not None else 0.0,
                )
            )
            blocks.append({"family": family, "op": op, "rows": rows})
        scenarios.append(
            {"degradation": degradation.name, "families": blocks}
        )
    return scenarios


def print_degraded(topology, payload_bytes, scenarios):
    for scenario in scenarios:
        print(
            f"== degraded ranking under [{scenario['degradation']}] on "
            f"{topology.describe()} =="
        )
        print(f"   payload {payload_bytes / (1 << 20):.0f} MiB/device\n")
        for block in scenario["families"]:
            print(f"-- {block['family']} ({block['op']}) --")
            print(
                f"{'algo':<14} {'healthy':>12} {'degraded':>12} "
                f"{'slowdown':>9}  degraded link utilization"
            )
            for row in block["rows"]:
                if not row["routable"]:
                    print(
                        f"{row['algo']:<14} "
                        f"{_fmt_s(row['healthy_s']):>12} "
                        f"{'unroutable':>12} {'-':>9}  (routed through a "
                        f"downed link)"
                    )
                    continue
                links = " ".join(
                    f"{name}={info['bytes'] / (1 << 20):.1f}MiB"
                    for name, info in sorted(row["links"].items())
                    if name != "flat" and info["bytes"] > 0
                )
                links = links or "(no surviving-link traffic)"
                print(
                    f"{row['algo']:<14} {_fmt_s(row['healthy_s']):>12} "
                    f"{_fmt_s(row['degraded_s']):>12} "
                    f"{row['slowdown']:>8.2f}x  {links}"
                )
            print()


def build_ranking(topology, payload_bytes, families):
    ranking = []
    for family in families:
        op = FAMILY_COLLECTIVES[family]
        rows = []
        for algo in SYNTHETIC_ALGOS:
            program = synthetic_program(algo, op, payload_bytes, topology)
            result = replay(program, topology)
            row = summarize(result, topology)
            row["algo"] = algo
            rows.append(row)
        flat_s = next(
            r["makespan_s"] for r in rows if r["algo"] == "flat"
        )
        for row in rows:
            row["speedup_vs_flat"] = (
                flat_s / row["makespan_s"] if row["makespan_s"] > 0 else None
            )
        rows.sort(key=lambda r: r["makespan_s"])
        ranking.append({"family": family, "op": op, "rows": rows})
    return ranking


def run_validation(history_dir):
    from ddlb_tpu_torch.perfmodel import calib
    from ddlb_tpu_torch.simulator.validate import (
        calibration_check,
        closed_form_check,
        history_check,
    )

    closed = closed_form_check()
    summary = {
        "closed_form": {
            "checked": len(closed),
            "failures": [r for r in closed if not r["ok"]],
            "max_rel_err": max((r["rel_err"] for r in closed), default=0.0),
        }
    }
    if history_dir:
        summary["history"] = history_check(history_dir)
        # gate 3 binds only with a table (DDLB_TPU_CALIB): an uncalibrated
        # world is judged by the lower-bound gates alone
        if calib.get_table() is not None:
            summary["calibration"] = calibration_check(history_dir)
    return summary


def print_ranking(topology, payload_bytes, ranking):
    print(f"== simulated algorithm ranking on {topology.describe()} ==")
    print(f"   payload {payload_bytes / (1 << 20):.0f} MiB/device\n")
    for block in ranking:
        print(f"-- {block['family']} ({block['op']}) --")
        print(f"{'algo':<14} {'predicted':>12} {'vs flat':>8}  link busy fractions")
        for row in block["rows"]:
            links = " ".join(
                f"{name}={info['busy_frac']:.2f}"
                for name, info in sorted(row["links"].items())
                if info["busy_frac"] > 0
            )
            speed = row["speedup_vs_flat"]
            print(
                f"{row['algo']:<14} {_fmt_s(row['makespan_s']):>12} "
                f"{(f'{speed:.2f}x' if speed else '?'):>8}  {links}"
            )
        print()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--topology", default=DEFAULT_TOPOLOGY,
        help=f"topology spec or preset (default: {DEFAULT_TOPOLOGY})",
    )
    parser.add_argument(
        "--payload-mib", type=float, default=64.0,
        help="per-device collective payload for the ranking (MiB)",
    )
    parser.add_argument(
        "--families", default=None,
        help="comma-separated subset of the ranked families",
    )
    parser.add_argument(
        "--degrade", action="append", default=None, metavar="SPEC",
        help="degradation scenario 'class=factor[,...]' (factor 0 = link "
        "down), repeatable — replays the ranking on the degraded twin "
        "of the topology next to the healthy one",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument(
        "--validate", action="store_true",
        help="run the closed-form + history validation gates instead "
        "(plus the calibration gate when DDLB_TPU_CALIB is set)",
    )
    parser.add_argument(
        "--history", default=None,
        help="observatory history directory for the validation join "
        "(default: DDLB_TPU_HISTORY)",
    )
    args = parser.parse_args(argv)

    try:
        topology = resolve_topology(args.topology)
    except (KeyError, ValueError) as exc:
        parser.error(f"bad --topology {args.topology!r}: {exc}")

    if args.validate:
        history_dir = args.history or env_history_dir() or None
        summary = run_validation(history_dir)
        ok = (
            not summary["closed_form"]["failures"]
            and ("history" not in summary or summary["history"]["ok"])
            and (
                "calibration" not in summary
                or summary["calibration"]["ok"]
            )
        )
        if args.as_json:
            print(json.dumps({"validation": summary, "ok": ok}, indent=2))
        else:
            cf = summary["closed_form"]
            print(
                f"closed-form agreement: {cf['checked']} configs, "
                f"{len(cf['failures'])} failures, max rel err "
                f"{cf['max_rel_err']:.2e}"
            )
            for failure in cf["failures"]:
                print(f"  FAIL {failure}")
            if "history" in summary:
                h = summary["history"]
                print(
                    f"history join: {h['checked']} keys checked, "
                    f"{h['skipped']} skipped, {len(h['violations'])} "
                    f"violations (rtol={h['rtol']}, "
                    f"lb_slack={h['lower_bound_slack']})"
                )
                for violation in h["violations"]:
                    print(f"  FAIL {violation}")
            if "calibration" in summary:
                c = summary["calibration"]
                print(
                    f"calibration join: {c['checked']} keys checked, "
                    f"{c['skipped']} skipped, {len(c['violations'])} "
                    f"violations (rtol={c['rtol']}, "
                    f"table {c['table_version'] or 'none'})"
                )
                for violation in c["violations"]:
                    print(f"  FAIL {violation}")
            print("VALIDATION " + ("PASSED" if ok else "FAILED"))
        return 0 if ok else 1

    families = RANKED_FAMILIES
    if args.families:
        wanted = [f.strip() for f in args.families.split(",") if f.strip()]
        unknown = [f for f in wanted if f not in RANKED_FAMILIES]
        if unknown:
            parser.error(
                f"unknown families {unknown}; ranked: {RANKED_FAMILIES}"
            )
        families = tuple(wanted)

    degradations = []
    for spec_text in args.degrade or ():
        try:
            degradations.append(parse_degradation(spec_text))
        except ValueError as exc:
            parser.error(str(exc))

    payload = args.payload_mib * (1 << 20)
    if degradations:
        # degraded mode: the failure-scenario ranking replaces the
        # healthy ranking + member sections (healthy numbers ride along
        # per row as the slowdown baseline)
        scenarios = build_degraded_ranking(
            topology, payload, families, degradations
        )
        if not scenarios:
            print("nothing to rank", file=sys.stderr)
            return 1
        if args.as_json:
            print(
                json.dumps(
                    json_safe(
                        {
                            "topology": {
                                "spec": topology.name,
                                "chip": topology.chip.name,
                                "pods": topology.pods,
                                "ici_mesh": list(topology.ici_mesh),
                                "chips": topology.num_chips,
                            },
                            "payload_bytes": payload,
                            "degraded": scenarios,
                        }
                    ),
                    indent=2,
                )
            )
            return 0
        print_degraded(topology, payload, scenarios)
        return 0

    ranking = build_ranking(topology, payload, families)
    if not ranking:
        print("nothing to rank", file=sys.stderr)
        return 1

    if args.as_json:
        print(
            json.dumps(
                {
                    "topology": {
                        "spec": topology.name,
                        "chip": topology.chip.name,
                        "pods": topology.pods,
                        "ici_mesh": list(topology.ici_mesh),
                        "chips": topology.num_chips,
                    },
                    "payload_bytes": payload,
                    "ranking": ranking,
                    "members": [],
                },
                indent=2,
            )
        )
        return 0
    print_ranking(topology, payload, ranking)
    return 0


if __name__ == "__main__":
    sys.exit(main())
