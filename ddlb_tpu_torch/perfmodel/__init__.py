"""The parts of the JAX package's ``perfmodel/`` that the serving cluster
reads: the hardware spec of the runtime's device (``specs``) and the
closed-form price of a KV handoff (``cost``)."""
