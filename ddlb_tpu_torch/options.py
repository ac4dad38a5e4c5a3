"""Option parsing shared by all primitives.

A copy of ``OptionsManager`` from the JAX package's ``options.py``: the
same schema contract and the same unknown-option and range errors, so a
sweep config is rejected identically by both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

# Keys consumed by the benchmark layer, silently ignored by primitives.
BENCHMARK_OPTIONS = {"implementation"}


class OptionsManager:
    """Validate per-implementation options against a declared schema.

    An implementation class declares ``DEFAULT_OPTIONS`` (name -> default)
    and ``ALLOWED_VALUES`` (name -> list of allowed values, or a 2-tuple
    ``(min, max)`` numeric range where ``None`` means unbounded). Unknown
    option names and out-of-range values raise ``ValueError``.
    """

    def __init__(
        self,
        defaults: Mapping[str, Any],
        allowed: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self.defaults = dict(defaults)
        self.allowed = dict(allowed or {})
        self.options: Dict[str, Any] = dict(self.defaults)
        #: option names the caller explicitly set (vs. defaulted)
        self.overridden: set = set()

    def parse(self, overrides: Mapping[str, Any]) -> Dict[str, Any]:
        for key, value in overrides.items():
            if key in BENCHMARK_OPTIONS:
                continue
            if key not in self.defaults:
                raise ValueError(
                    f"Unknown option '{key}'. Valid options: "
                    f"{sorted(self.defaults)}"
                )
            self._check_allowed(key, value)
            self.options[key] = value
            self.overridden.add(key)
        return self.options

    def _check_allowed(self, key: str, value: Any) -> None:
        spec = self.allowed.get(key)
        if spec is None:
            return
        if isinstance(spec, tuple) and len(spec) == 2:
            lo, hi = spec
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                raise ValueError(
                    f"Option '{key}' expects a number in range {spec}, "
                    f"got {value!r}"
                )
            if (lo is not None and value < lo) or (hi is not None and value > hi):
                raise ValueError(
                    f"Option '{key}'={value!r} outside allowed range {spec}"
                )
            return
        if value not in spec:
            raise ValueError(
                f"Option '{key}'={value!r} not in allowed values {list(spec)}"
            )

    def get(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self.options[key]

    def __contains__(self, key: str) -> bool:
        return key in self.options
