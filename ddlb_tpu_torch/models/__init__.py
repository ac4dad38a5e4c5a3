"""The flagship model's serving subset: configuration, parameters, the
forward pieces (``transformer.py``), the KV-cache decode/prefill/generate
steps (``decode.py``) and the continuous-batching engine (``serving.py``)."""
