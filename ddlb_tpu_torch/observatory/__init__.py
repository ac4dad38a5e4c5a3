"""The port's observatory: the JAX package's ``observatory/`` but the
flight recorder's world timeline. ``attribution`` (a row's measured
overlap and phase breakdown against its cost model), ``store`` (the
``DDLB_TPU_HISTORY`` bank of result rows; ``DDLB_TPU_RUN_ID``),
``calibrate`` (the calibration table fitted from the bank), ``regress``
(the current run against the bank: time, SLO, skew, calibration and
health gates), ``health`` (the persistent-straggler and exoneration
verdicts) and ``live`` (the ``DDLB_TPU_LIVE`` event stream the sweep
dashboard tails). Stdlib only; observability never aborts the row it
observes."""

from __future__ import annotations

from ddlb_tpu_torch.observatory.attribution import (
    ATTRIBUTION_ROW_DEFAULTS,
    attribute,
)
from ddlb_tpu_torch.observatory.live import post_event
from ddlb_tpu_torch.observatory.store import bank_row, load_history, row_key

__all__ = [
    "ATTRIBUTION_ROW_DEFAULTS",
    "attribute",
    "bank_row",
    "load_history",
    "post_event",
    "row_key",
]
