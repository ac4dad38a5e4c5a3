"""Rank-tagged structured logger for multi-process benchmark output.

The port of the JAX package's ``telemetry/logger.py``. On a multi-process
world N ranks interleave lines; ``log`` keeps the human-readable line but
makes it attributable and machine-parseable:

- every line starts ``[ddlb_tpu_torch][p<rank>]`` (the rank is torchrun's
  ``RANK``); the prefix differs from the JAX package's ``[ddlb_tpu]`` so
  a mixed log keeps the two apart;
- structured ``key=value`` fields append after the message, sorted, so
  a grep-consumer and a human read the same line;
- multi-line messages get the prefix on every line;
- when tracing is enabled, each log line is mirrored into the trace as
  a ``log`` instant, so Perfetto shows the warnings on the span timeline.

The rank is re-read per call, so a spawned child's environment is honoured.
"""

from __future__ import annotations

from typing import Any

from ddlb_tpu_torch.telemetry import trace

#: ``instant``'s own parameter names: a field of that name is mirrored as
#: ``field_<name>``
RESERVED_FIELDS = frozenset({"name", "cat", "level", "message"})


def log(
    msg: str, *, level: str = "info", mirror: bool = True, **fields: Any
) -> None:
    """Emit one rank-tagged diagnostic line (flushed to stdout).

    ``level`` other than "info" is rendered as an uppercase prefix
    (``WARNING: ...``). ``fields`` append as sorted ``key=value`` pairs.
    ``mirror=False`` skips the trace instant, for bulk echoes (result
    tables) whose payload would bloat the merged trace.
    """
    prefix = f"[ddlb_tpu_torch][p{trace._rank()}]"
    body = str(msg)
    if level != "info":
        body = f"{level.upper()}: {body}"
    if fields:
        kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        body = f"{body}  {kv}"
    text = "\n".join(f"{prefix} {line}" for line in body.splitlines() or [""])
    print(text, flush=True)
    if not mirror:
        return
    # fields are caller-chosen: names colliding with instant()'s own
    # parameters must not turn a diagnostic into a TypeError
    safe = {
        (f"field_{k}" if k in RESERVED_FIELDS else k): v for k, v in fields.items()
    }
    trace.instant("log", cat="log", level=level, message=str(msg), **safe)


def warn(msg: str, **fields: Any) -> None:
    """``log(..., level="warning")`` shorthand."""
    log(msg, level="warning", **fields)


def error(msg: str, **fields: Any) -> None:
    """``log(..., level="error")`` shorthand (still stdout)."""
    log(msg, level="error", **fields)
