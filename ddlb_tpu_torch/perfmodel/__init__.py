"""The port's perfmodel: the JAX package's ``perfmodel/``. ``specs`` (the
hardware registry: peaks by dtype, memory, link rates, whether a node is
one switched fabric; ``DDLB_TPU_CHIP``), ``cost`` (every family's cost
model, the row's roofline, the calibrated prediction, the handoff price,
the ring census and the link multiplier), ``calib`` (the calibration
table fitted from banked history; ``DDLB_TPU_CALIB``) and ``topology``
(the simulator's synthetic worlds of H100 nodes)."""
