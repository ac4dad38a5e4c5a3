"""The port's perfmodel: the JAX package's ``perfmodel/`` but its
simulator topologies. ``specs`` (the hardware registry: peaks by dtype,
memory, link rates; ``DDLB_TPU_CHIP``), ``cost`` (every family's cost
model, the row's roofline, the calibrated prediction, the handoff price
and the ring census) and ``calib`` (the calibration table fitted from
banked history; ``DDLB_TPU_CALIB``)."""
