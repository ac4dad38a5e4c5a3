"""The port's models: the flagship MoE transformer (``transformer.py``: its
configuration, parameters, training step and oracle; ``pipeline.py``: the
1F1B and interleaved schedules), its KV-cache decode/prefill/generate
steps (``decode.py``) and continuous-batching engine (``serving.py``), the
train-state checkpoint (``checkpoint.py``) and the tensor-parallel MLP
block (``tp_mlp.py``), whose entry points this package exports as the JAX
package's ``models`` does."""

from ddlb_tpu_torch.models.tp_mlp import (  # noqa: F401
    example_batch,
    init_params,
    make_train_step,
    mlp_block,
    mlp_forward,
)
