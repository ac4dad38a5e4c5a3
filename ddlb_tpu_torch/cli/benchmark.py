"""CLI / config expansion for the port's sweep runner.

The port of the JAX package's ``cli/benchmark.py``: a JSON config (the
shape of ``scripts/config.json``), ``name;k=v,v`` impl-spec flags, and a
programmatic dict all normalise into one config that is expanded over
per-implementation option lists and over (m, n, k) shape lists. Runs on
the card unless the config says ``"device": "cpu"`` (CLI ``--device
cpu``). Under ``torchrun`` every rank runs the same sweep; rank 0 writes
the CSV and prints the table.

    python -m ddlb_tpu_torch.cli.benchmark --primitive tp_columnwise \\
        --impl cuda -m 8192 -n 8192 -k 8192
    python -m ddlb_tpu_torch.cli.benchmark --config scripts/config.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Any, Dict, List, Tuple

import torch.distributed as dist

from ddlb_tpu_torch.benchmark import PrimitiveBenchmarkRunner
from ddlb_tpu_torch.primitives.registry import ALLOWED_PRIMITIVES
from ddlb_tpu_torch.runtime import DEVICES, env_rank

#: config keys the port reads; any other key raises rather than being
#: silently ignored (the JAX runner's isolation, pool, retry and
#: compile-ahead knobs are not ported yet)
CONFIG_KEYS = (
    "primitive",
    "m",
    "n",
    "k",
    "dtype",
    "validate",
    "num_iterations",
    "num_warmups",
    "time_measurement_backend",
    "barrier_at_each_iteration",
    "output_csv",
    "implementations",
    "device",
    "device_loop_windows",
)

TABLE_COLUMNS = (
    "implementation",
    "option",
    "m",
    "n",
    "k",
    "dtype",
    "mean time (ms)",
    "std time (ms)",
    "Throughput (TFLOPS)",
    "world_size",
    "valid",
)


def _infer_scalar(text: str) -> Any:
    """'true'/'false' -> bool, then int, then float, else str."""
    low = text.strip().lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text.strip()


def _parse_value_list(text: str) -> List[Any]:
    return [_infer_scalar(v) for v in text.split(",") if v.strip() != ""]


def _parse_int_list(values: List[str]) -> List[int]:
    out: List[int] = []
    for v in values:
        out.extend(int(x) for x in str(v).split(",") if x.strip() != "")
    return out


def parse_impl_spec(spec: str) -> Tuple[str, Dict[str, List[Any]]]:
    """``'pytorch;order=AG_before,AG_after'`` ->
    ``('pytorch', {'order': ['AG_before', 'AG_after']})``."""
    parts = [p for p in spec.split(";") if p.strip() != ""]
    if not parts:
        raise ValueError(f"Empty implementation spec: {spec!r}")
    name = parts[0].strip()
    options: Dict[str, List[Any]] = {}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(
                f"Bad option {part!r} in spec {spec!r} (expected key=value[,value])"
            )
        key, _, value = part.partition("=")
        options[key.strip()] = _parse_value_list(value)
    return name, options


def generate_config_combinations(
    implementations: Dict[str, List[Dict[str, Any]]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Expand list-valued options into the cartesian product per block."""
    expanded: Dict[str, List[Dict[str, Any]]] = {}
    for impl_name, blocks in implementations.items():
        expanded[impl_name] = []
        for block in blocks:
            list_params = {k: v for k, v in block.items() if isinstance(v, list)}
            if not list_params:
                expanded[impl_name].append(dict(block))
                continue
            keys = list(list_params)
            for combo in itertools.product(*(list_params[k] for k in keys)):
                cfg = dict(block)
                cfg.update(zip(keys, combo))
                expanded[impl_name].append(cfg)
    return expanded


def assign_impl_ids(
    expanded: Dict[str, List[Dict[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    """``{name: [cfg, ...]}`` -> ``{f'{name}_{i}': cfg + implementation key}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, configs in expanded.items():
        for i, cfg in enumerate(configs):
            cfg = dict(cfg)
            cfg["implementation"] = name
            out[f"{name}_{i}"] = cfg
    return out


def _normalize(config: Dict[str, Any]) -> Dict[str, Any]:
    cfg = dict(config.get("benchmark", config))
    unknown = sorted(set(cfg) - set(CONFIG_KEYS))
    if unknown:
        raise ValueError(
            f"config keys {unknown} are not supported by ddlb_tpu_torch "
            f"(supported: {list(CONFIG_KEYS)})"
        )
    impls = cfg.get("implementations")
    if isinstance(impls, list):
        # JSON list form [{"name": n, ...opts}, ...] -> {name: [opts, ...]}
        as_dict: Dict[str, List[Dict[str, Any]]] = {}
        for block in impls:
            block = dict(block)
            name = block.pop("name", None)
            if not name:
                raise ValueError(
                    f"implementation list entries need a 'name': {block!r}"
                )
            as_dict.setdefault(name, []).append(block)
        cfg["implementations"] = as_dict
    return cfg


def _as_list(value) -> List[int]:
    return [int(v) for v in (value if isinstance(value, list) else [value])]


def format_table(rows: List[Dict[str, Any]]) -> str:
    """The result rows as a fixed-width text table of ``TABLE_COLUMNS``."""
    cells = [list(TABLE_COLUMNS)] + [
        [
            f"{r[c]:.4g}" if isinstance(r[c], float) else str(r[c])
            for c in TABLE_COLUMNS
        ]
        for r in rows
    ]
    widths = [max(len(row[i]) for row in cells) for i in range(len(TABLE_COLUMNS))]
    return "\n".join(
        "  ".join(cell.rjust(w) for cell, w in zip(row, widths)) for row in cells
    )


def run_benchmark(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Run the full sweep described by ``config``; returns the rows."""
    cfg = _normalize(config)
    primitive = cfg.get("primitive", "tp_columnwise")
    dtype = cfg.get("dtype", "bfloat16")
    impl_map = assign_impl_ids(
        generate_config_combinations(cfg.get("implementations", {}))
    )
    if not impl_map:
        raise ValueError("Config contains no implementations")

    shapes = list(
        itertools.product(
            _as_list(cfg.get("m", 8192)),
            _as_list(cfg.get("n", 8192)),
            _as_list(cfg.get("k", 8192)),
        )
    )
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    output_csv = cfg.get("output_csv")
    if output_csv is None:
        m0, n0, k0 = shapes[0]
        output_csv = (
            f"results/{primitive}_{m0}x{k0}x{n0}_{dtype}_{timestamp}.csv"
        )
    output_csv = output_csv.replace("{timestamp}", timestamp)

    rows: List[Dict[str, Any]] = []
    for m, n, k in shapes:
        runner = PrimitiveBenchmarkRunner(
            primitive=primitive,
            m=m,
            n=n,
            k=k,
            implementations=impl_map,
            dtype=dtype,
            num_iterations=cfg.get("num_iterations", 50),
            num_warmups=cfg.get("num_warmups", 5),
            validate=cfg.get("validate", True),
            time_measurement_backend=cfg.get(
                "time_measurement_backend", "host_clock"
            ),
            barrier_at_each_iteration=cfg.get("barrier_at_each_iteration", True),
            output_csv=output_csv,
            device=cfg.get("device", "cuda"),
            device_loop_windows=cfg.get("device_loop_windows", 5),
        )
        rows.extend(runner.run())
    if env_rank() == 0:
        print("\n=== Benchmark results ===")
        print(format_table(rows))
        print(f"\nResults written to {output_csv}")
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Distributed primitive benchmark (PyTorch/CUDA)"
    )
    parser.add_argument(
        "--config", default=None, metavar="JSON",
        help="run the sweep a JSON config describes (scripts/config.json "
        "shape); the other flags are then ignored, except --device",
    )
    parser.add_argument(
        "--primitive", default="tp_columnwise", choices=list(ALLOWED_PRIMITIVES)
    )
    parser.add_argument(
        "--impl",
        action="append",
        default=None,
        metavar="NAME[;OPT=V1,V2...]",
        help="implementation spec; repeatable",
    )
    parser.add_argument("-m", action="append", default=None)
    parser.add_argument("-n", action="append", default=None)
    parser.add_argument("-k", action="append", default=None)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--num-iterations", type=int, default=50)
    parser.add_argument("--num-warmups", type=int, default=5)
    parser.add_argument("--no-validate", action="store_true")
    parser.add_argument(
        "--timing", default="host_clock", choices=["host_clock", "device_loop"]
    )
    parser.add_argument("--no-barrier", action="store_true")
    parser.add_argument("--csv", default=None, help="output CSV ({timestamp} token)")
    parser.add_argument(
        "--device", default=None, choices=list(DEVICES),
        help="where to run (default: cuda, the card)",
    )
    args = parser.parse_args(argv)

    if args.config:
        config = _normalize(load_config(args.config))
    else:
        implementations: Dict[str, List[Dict[str, Any]]] = {}
        for spec in args.impl or ["pytorch"]:
            name, options = parse_impl_spec(spec)
            implementations.setdefault(name, []).append(options)
        config = {
            "primitive": args.primitive,
            "m": _parse_int_list(args.m or ["1024"]),
            "n": _parse_int_list(args.n or ["1024"]),
            "k": _parse_int_list(args.k or ["1024"]),
            "dtype": args.dtype,
            "num_iterations": args.num_iterations,
            "num_warmups": args.num_warmups,
            "validate": not args.no_validate,
            "time_measurement_backend": args.timing,
            "barrier_at_each_iteration": not args.no_barrier,
            "implementations": implementations,
            "output_csv": args.csv,
        }
    if args.device:
        config["device"] = args.device
    try:
        run_benchmark(config)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


if __name__ == "__main__":
    main()
