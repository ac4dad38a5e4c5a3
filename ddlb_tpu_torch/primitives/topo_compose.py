"""Composition choice for the topology-adaptive members.

A copy of the JAX package's ``primitives/topo_compose.py``. The
``pytorch_hier`` / ``pytorch_striped`` members of ``collectives``,
``dp_allreduce`` and ``ep_alltoall`` take a ``composition`` option:
``flat`` (one ring over every rank), ``hierarchical`` (the two-level
decomposition inside and between nodes, HiCCL, arxiv 2408.05962),
``striped`` (one concurrent ring family per axis of a node's torus
factorization, FlexLink, arxiv 2510.15882), or ``auto``, which resolves
here.

In the port ``auto`` resolves from the topology alone
(``Runtime.num_slices``): ``hierarchical`` at more than one node, ``flat``
at one, where the compositions degenerate. The JAX policy also reads the
degraded-world stamp (``DDLB_TPU_WORLD_DEGRADED``), the fault plan's link
faults (``DDLB_TPU_FAULT_PLAN``) and the banked health verdict
(``DDLB_TPU_HISTORY``) and then picks ``striped``; those readers come
with the port's ``faults/`` and ``observatory/``. Until then a set one
is logged, not read, and never fails a run. The resolved choice is
stamped on every row as the ``composition`` column.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

from ddlb_tpu_torch import telemetry
from ddlb_tpu_torch.perfmodel.cost import (
    hierarchical_wire_bytes,
    striped_wire_bytes,
    torus_factors,
)

log = logging.getLogger(__name__)

#: the composition vocabulary, ``auto`` excluded (it resolves to one of these)
COMPOSITIONS = ("flat", "hierarchical", "striped")

#: the health inputs of the JAX policy that the port does not read yet
_HEALTH_ENV = ("DDLB_TPU_WORLD_DEGRADED", "DDLB_TPU_FAULT_PLAN", "DDLB_TPU_HISTORY")


def two_level_factors(num_partitions: int, num_slices: int) -> Tuple[int, int]:
    """The (intra, inter) factorization of a ``num_partitions`` world of
    ``num_slices`` nodes; inter falls back to 1 when the node count does
    not divide the world."""
    d = max(1, int(num_partitions))
    inter = max(1, int(num_slices or 1))
    if inter > d or d % inter:
        inter = 1
    return d // inter, inter


def select_composition(requested: str, num_partitions: int,
                       num_slices: int) -> Tuple[str, str]:
    """Resolve a ``composition`` option to one of ``COMPOSITIONS`` and a
    reason. A pinned composition passes through."""
    if requested != "auto":
        if requested not in COMPOSITIONS:
            raise ValueError(
                f"composition must be one of {COMPOSITIONS + ('auto',)}, "
                f"got {requested!r}"
            )
        return requested, "pinned"
    unread = [name for name in _HEALTH_ENV if os.environ.get(name, "").strip()]
    if unread:
        log.warning(
            "composition='auto' resolved from the topology only: the port "
            "does not read %s yet", ", ".join(unread)
        )
    _intra, inter = two_level_factors(num_partitions, num_slices)
    if inter > 1:
        return "hierarchical", (
            f"{inter}-node world: the between-node phase carries 1/intra "
            "of the payload"
        )
    return "flat", "single-node world: the compositions degenerate"


class ComposedMember:
    """Mixin for the ``pytorch_hier`` / ``pytorch_striped`` members: the
    composition's resolution, the closed-form wire census by composition,
    and the ``composition`` row column. It works on duck-typed stubs as on
    live members (``options``, ``num_partitions``, ``runtime.num_slices``).

    A family lists its collective payloads in ``_collective_payloads()``,
    ``[(op, local_nbytes), ...]``; the mixin prices them with
    ``cost.hierarchical_wire_bytes`` / ``cost.striped_wire_bytes`` and
    defers to the family base (the flat ring) when the composition
    resolves ``flat``.
    """

    def _resolved_composition(self) -> str:
        """The resolved composition, resolved again only when its inputs
        (the requested composition, the world and its node count) moved; a
        re-resolution to a different composition is a ``topo.recompose``
        instant, as in the JAX package."""
        runtime = getattr(self, "runtime", None)
        num_slices = int(getattr(runtime, "num_slices", 1) or 1)
        requested = self.options.get("composition", "auto")
        signature = (requested, self.num_partitions, num_slices)
        cached = getattr(self, "_composition", None)
        if cached is not None and signature == self._composition_sig:
            return cached
        resolved, reason = select_composition(requested, self.num_partitions, num_slices)
        if cached is not None and resolved != cached:
            telemetry.instant("topo.recompose", cat="topo", previous=cached,
                              composition=resolved, reason=reason)
        self._composition, self._composition_sig = resolved, signature
        return resolved

    def _two_level(self) -> Tuple[int, int]:
        """(intra, inter) for this member's world."""
        runtime = getattr(self, "runtime", None)
        return two_level_factors(self.num_partitions,
                                 int(getattr(runtime, "num_slices", 1) or 1))

    def _torus(self) -> Tuple[int, int]:
        """A node's (sx, sy) torus factorization: the stripe axes."""
        intra, _inter = self._two_level()
        return torus_factors(intra)

    def _stripe_count(self) -> int:
        sx, sy = self._torus()
        return max(1, sum(1 for a in (sx, sy) if a > 1))

    def _stripe_axes(self) -> list:
        """The torus axes the stripes lead with, one a stripe (``sx`` for a
        one-card node, whose stripe is the between-node phase alone)."""
        sx, sy = self._torus()
        return [name for name, a in (("sx", sx), ("sy", sy)) if a > 1] or ["sx"]

    def wire_bytes(self) -> float:
        comp = self._resolved_composition()
        if comp == "flat":
            return super().wire_bytes()
        intra, inter = self._two_level()
        total = 0.0
        for op, nbytes in self._collective_payloads():
            if comp == "hierarchical":
                cls = hierarchical_wire_bytes(op, nbytes, intra, inter)
            else:
                cls = striped_wire_bytes(op, nbytes, inter, self._torus())
            total += cls["ici"] + cls["dcn"]
        return total

    def extra_row_fields(self) -> dict:
        fields = dict(super().extra_row_fields())
        fields["composition"] = self._resolved_composition()
        return fields

    def _check_composed(self) -> str:
        """The family-independent guards of a composed member; returns the
        resolved composition. A composition other than ``flat`` builds its
        own views of the world, so an overridden ``transport`` is refused."""
        comp = self._resolved_composition()
        if comp != "flat" and "transport" in self._options_manager.overridden:
            raise ValueError(
                "hierarchical/striped compositions build their own "
                "two-level/torus views; the transport axis does not apply"
            )
        return comp
