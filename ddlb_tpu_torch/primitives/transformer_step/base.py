"""TransformerStep: the flagship model's training step as a primitive.

The counterpart of the JAX package's ``transformer_step/base.py``: one
full train step of the MoE transformer (forward, backward through every
collective and the flash kernels, the AdamW update) or its forward loss,
measured through the same runner, rows and CSV as every other family, so
that what the primitives compose into is a measured row.

Shape mapping onto ``(m, n, k)``: ``m`` the sequence length, ``n``
d_model, ``k`` d_ff (per expert). The option schema is the JAX package's
(:53-92), value for value, every value ported: the learned routers
(``router=topk|expert_choice`` with ``router_topk`` and
``capacity_factor``) and ``mlp_kernel=int8_weights`` (with
``mode='forward'``, as in the JAX package). The chain is ``pp * virtual`` stages deep (``_total_stages``; ``virtual``
is an option of ``spmd`` only): the parameters, ``flops()`` and the
oracle count them all.

Throughput uses the model-FLOPs census of ``flops()`` (three times the
forward's matmul FLOPs for a train step), not 2mnk. Validation holds the
step's loss (taken before the update) against the single-device oracle
``models.transformer.reference_loss`` at atol 1e-4 in float32 and 2e-2 in
half precision, twice that with an int8 MLP in half precision (:311-337).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.models.transformer import (
    TransformerConfig,
    example_tokens,
    init_params,
    place_params,
    reference_loss,
)
from ddlb_tpu_torch.primitives.base import Primitive, matmul_precision_scope, torch_dtype

log = logging.getLogger(__name__)

#: oracle losses by (config, mesh, seed), one per process: every validated
#: row at one shape asks for the same one
_ORACLE_MEMO: Dict[tuple, float] = {}

class TransformerStep(Primitive):
    """ABC for the flagship model's step implementations."""

    primitive_name = "transformer_step"

    BASE_OPTIONS = {
        "mode": "train",
        "batch": 4,
        "vocab": 512,
        "n_heads": 8,
        "n_kv_heads": 0,
        "layers_per_stage": 1,
        "microbatches": 2,
        "attention": "gathered",
        "attn_kernel": "flash",
        "mlp_kernel": "bf16",
        "rope": False,
        "attn_window": 0,
        "router": "block",
        "router_topk": 2,
        "capacity_factor": 1.25,
        "dp": 0,
        "tp": 0,
        "pp": 0,
    }
    BASE_ALLOWED = {
        "mode": ["train", "forward"],
        "batch": (1, None),
        "vocab": (2, None),
        "n_heads": (1, None),
        "n_kv_heads": (0, None),
        "layers_per_stage": (1, None),
        "microbatches": (1, None),
        "attention": ["gathered", "ring"],
        "attn_kernel": ["flash", "einsum"],
        "mlp_kernel": ["bf16", "int8", "int8_weights"],
        "rope": [True, False],
        "attn_window": (0, None),
        "router": ["block", "topk", "expert_choice"],
        "router_topk": (1, 4),
        "capacity_factor": (0.25, 8.0),
        "dp": (0, None),
        "tp": (0, None),
        "pp": (0, None),
    }

    @property
    def _call_args(self):
        return self._args

    # -- mesh ------------------------------------------------------------------

    def _mesh_factors(self) -> Tuple[int, int, int]:
        """(dp, tp, pp): explicit options, or the JAX package's auto
        factorization of the world (:152-176): pp = 2 where the world is
        even, tp = 2 where what is left is even, dp the rest."""
        n = self.runtime.world_size
        dp, tp, pp = self.options["dp"], self.options["tp"], self.options["pp"]
        if dp and tp and pp:
            if dp * tp * pp != n:
                raise ValueError(f"dp*tp*pp = {dp * tp * pp} != {n} devices")
            return dp, tp, pp
        if dp or tp or pp:
            raise ValueError("set all of dp/tp/pp or none (0 = auto)")
        pp = 2 if n % 2 == 0 else 1
        tp = 2 if n % (2 * pp) == 0 else 1
        return n // (pp * tp), tp, pp

    # -- contract --------------------------------------------------------------

    def _check_shapes(self) -> None:
        o = self.options
        dp, tp, pp = self._mesh_factors()
        if self.n % o["n_heads"] != 0:
            raise ValueError(
                f"n={self.n} (d_model) must be divisible by n_heads={o['n_heads']}"
            )
        if self.m % tp != 0:
            raise ValueError(f"m={self.m} (seq) not divisible by tp={tp}")
        if o["attention"] == "gathered" and o["n_heads"] % tp != 0:
            raise ValueError(
                f"n_heads={o['n_heads']} not divisible by tp={tp} "
                f"(gathered attention shards heads)"
            )
        if o["n_kv_heads"]:
            if o["n_heads"] % o["n_kv_heads"] != 0:
                raise ValueError(
                    f"n_heads={o['n_heads']} not divisible by "
                    f"n_kv_heads={o['n_kv_heads']}"
                )
            if o["attention"] == "gathered" and o["n_kv_heads"] % tp != 0:
                raise ValueError(
                    f"n_kv_heads={o['n_kv_heads']} not divisible by tp={tp}"
                )
        if o["batch"] % (dp * o["microbatches"]) != 0:
            raise ValueError(
                f"batch={o['batch']} not divisible by dp*microbatches="
                f"{dp * o['microbatches']}"
            )
        if (o["batch"] // dp // o["microbatches"]) * (self.m // tp) % tp != 0:
            # the JAX member checks this for every router
            raise ValueError(
                "per-microbatch local tokens must divide by tp for the MoE "
                "block router"
            )
        if self.dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError("transformer_step requires a floating dtype")
        if o["mlp_kernel"] == "int8_weights" and o["mode"] != "forward":
            raise ValueError(
                "mlp_kernel='int8_weights' (pre-quantized serving weights) "
                "requires mode='forward'; use mlp_kernel='int8' for train"
            )

    def flops(self) -> float:
        """Model matmul FLOPs of one step (:225-246): per token and layer
        ``(4 + 4 kv/h) D^2 + 2 S D + 4 D F``, plus ``2 D V`` for the head;
        a train step counts three times the forward (recomputation is not
        counted)."""
        o = self.options
        D, Fd, S = self.n, self.k, self.m
        layers = self._total_stages() * o["layers_per_stage"]
        kv_frac = (o["n_kv_heads"] or o["n_heads"]) / o["n_heads"]
        per_token = layers * ((4.0 + 4.0 * kv_frac) * D * D + 2.0 * S * D + 4.0 * D * Fd)
        per_token += 2.0 * D * o["vocab"]
        fwd = o["batch"] * S * per_token
        return 3.0 * fwd if o["mode"] == "train" else fwd

    def _total_stages(self) -> int:
        """The chain's depth: pp stages, ``virtual`` chunks each (JAX
        :248; the spmd member's ``virtual``)."""
        return self._mesh_factors()[2] * self.options.get("virtual", 1)

    # -- model, parameters, tokens --------------------------------------------

    def _model_config(self) -> TransformerConfig:
        o = self.options
        return TransformerConfig(
            vocab=o["vocab"], d_model=self.n, n_heads=o["n_heads"],
            n_kv_heads=o["n_kv_heads"], d_ff=self.k,
            layers_per_stage=o["layers_per_stage"],
            microbatches=o["microbatches"], attention=o["attention"],
            attn_kernel=o["attn_kernel"], mlp_kernel=o["mlp_kernel"],
            rope=o["rope"], attn_window=o["attn_window"], router=o["router"],
            router_topk=o["router_topk"], capacity_factor=o["capacity_factor"],
            dtype=torch_dtype(self.dtype),
        )

    def _host_params(self) -> dict:
        """The full parameters on the host (every stage, head and expert),
        in stage order: ``init_params`` with ``_total_stages()`` stages and
        ``tp`` experts."""
        _, tp, _ = self._mesh_factors()
        return init_params(self._model_config(), self._total_stages(), n_experts=tp,
                           seed=self.seed)

    def _host_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        return example_tokens(self.options["batch"], self.m, self.options["vocab"],
                              seed=self.seed)

    # -- validation --------------------------------------------------------------

    def _oracle_loss(self) -> float:
        """``reference_loss`` on the same seeded parameters and tokens, on
        this rank's device under the dtype's precision scope; memoised."""
        dp, tp, pp = self._mesh_factors()
        key = (self._model_config(), dp, tp, pp, self._total_stages(), self.m,
               self.options["batch"], self.seed)
        if key not in _ORACLE_MEMO:
            _ORACLE_MEMO.clear()
            cfg = self._model_config()
            params = place_params(self._host_params(), self.device)
            tokens, targets = (torch.from_numpy(x).to(self.device)
                               for x in self._host_tokens())
            with torch.no_grad(), matmul_precision_scope(self.dtype):
                loss = reference_loss(params, tokens, targets, cfg, tp=tp, dp=dp)
            _ORACLE_MEMO[key] = float(loss)
            del params
        return _ORACLE_MEMO[key]

    def validate(self, result) -> bool:
        """The step's loss against the oracle's: ``result`` is the loss
        (forward) or the ``(params, opt_state, loss)`` triple (train)."""
        loss = result[-1] if isinstance(result, (tuple, list)) else result
        loss = float(loss)
        atol = 1e-4 if self.dtype == "float32" else 2e-2
        if self.options["mlp_kernel"] != "bf16" and self.dtype != "float32":
            # half-precision noise upstream of the int8 MLP can flip a
            # quantization rounding (:326-330)
            atol *= 2
        expected = self._oracle_loss()
        ok = bool(np.isfinite(loss) and abs(loss - expected) <= atol)
        if not ok:
            log.warning(
                "validation FAILED for %s rank %d: loss=%.6f oracle=%.6f atol=%g",
                type(self).__name__, self.rank, loss, expected, atol,
            )
        return ok
