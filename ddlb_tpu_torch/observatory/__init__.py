"""The parts of the JAX package's ``observatory/`` that ported code reads:
the exoneration verdict of ``health``."""
