"""The port's observatory: the JAX package's ``observatory/`` parts that
ported code reads. ``attribution`` (a row's measured overlap and phase
breakdown against its cost model), ``store`` (the ``DDLB_TPU_HISTORY``
bank of result rows), ``calibrate`` (the calibration table fitted from
the bank) and ``health`` (the exoneration verdict)."""
