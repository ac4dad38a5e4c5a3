"""Compiler-partitioned serving step: the full-width decode and prefill on
DTensors, compiled.

The counterpart of the JAX package's ``transformer_decode/xla_gspmd.py``:
the single-program formulation ``models.decode.make_full_width_fns``
(every head, ``routed_moe``'s expert blocks, no collective) runs on
DTensor parameters over a ``(dp, tp)`` device mesh, placed as
``param_specs`` places them with the pp axis dropped, with the cache's
batch over dp and its kv heads over tp (``dtensor_cache``). DTensor
picks every collective and Inductor schedules them; the schema carries
the compiler knobs of ``compile_options``.

- ``decode``: the cache is filled once at set-up by an uncompiled
  prefill, inside the dtype's precision scope; one measured call is one
  compiled step at position m, passed as a 0-d tensor so that a new
  position would not be a new program. The step writes its row into a
  new cache inside the graph and returns the logits only.
- ``prefill``: the compiled prompt pass; its logits are the row's result.

The logits are asked for with their rows over dp and replicated over tp
(a DTensor result may otherwise be a partial sum, whose local shard is
not the answer).

The einsum formulation is what this member measures: ``attn_kernel``
defaults to ``einsum``, and ``flash``, ``decode_kernel='pallas'`` and the
serving loops (``phase=generate|speculate|serve``) raise with the JAX
member's messages. ``mlp_kernel='int8'`` and ``'int8_weights'`` run K7
through its ``torch.library`` operators (``ops.quantized_matmul``), opaque
nodes of the graph: on the card each call launches K7 and counts it.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ddlb_tpu_torch.models.decode import dtensor_cache, make_full_width_fns
from ddlb_tpu_torch.models.transformer import dtensor_params
from ddlb_tpu_torch.primitives.base import matmul_precision_scope
from ddlb_tpu_torch.primitives.compile_options import (
    CompiledOptionsMixin,
    local,
    register_missing_rules,
)
from ddlb_tpu_torch.primitives.transformer_decode.base import TransformerDecode
from ddlb_tpu_torch.runtime import placements


class CompiledTransformerDecode(CompiledOptionsMixin, TransformerDecode):
    # the single program keeps the einsum attention form: the default
    # records einsum, and an explicit flash request raises
    DEFAULT_OPTIONS = {**CompiledOptionsMixin.DEFAULT_OPTIONS, "attn_kernel": "einsum"}

    def _check_shapes(self) -> None:
        super()._check_shapes()
        o = self.options
        if o["attn_kernel"] == "flash":
            raise ValueError(
                "compiled measures the einsum formulation; "
                "attn_kernel='flash' applies to the spmd member"
            )
        if o["decode_kernel"] == "pallas":
            raise ValueError(
                "compiled measures the einsum formulation; "
                "decode_kernel='pallas' applies to the spmd member"
            )
        if o["phase"] in ("generate", "speculate", "serve"):
            raise ValueError(
                f"phase='{o['phase']}' (the compiled serving loop) is an "
                "spmd/compute_only measurement; compiled measures the single "
                "decode/prefill step"
            )

    def _dp_rows(self) -> slice:
        dp, tp = self._mesh_factors()
        b = self.options["batch"] // dp
        at = self.rank // tp * b  # this rank's dp block
        return slice(at, at + b)

    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp = self._mesh_factors()
        mesh = self.runtime.device_mesh(("dp", "tp"), (dp, tp))
        self.num_partitions = dp * tp
        B = self.options["batch"]
        decode_fwd, prefill_fwd = make_full_width_fns(cfg, B, dp, tp)
        # the set-up prefill below runs on DTensors before any compile: its
        # LM head is aten.mm.dtype on the card, which needs its rule now
        register_missing_rules()
        params = dtensor_params(self._host_params(tp), cfg, mesh, self.device)
        # with tp = 1 the rank holds every head and expert: the oracle's
        self.params = local(params)
        prompt, nxt = self._host_tokens()
        rows, data = self._dp_rows(), placements(mesh, {"dp": 0})

        def batch_rows(x):
            x = torch.from_numpy(x[rows].copy()).to(self.device)
            return DTensor.from_local(x, mesh, data, run_check=False)

        if self.options["phase"] == "decode":
            cache = dtensor_cache(cfg, B, self.m + 1, mesh, self.device)
            with matmul_precision_scope(self.dtype), implicit_replication():
                _, cache = prefill_fwd(params, cache, batch_rows(prompt))
            tok = batch_rows(nxt)
            pos = torch.tensor(self.m, device=self.device)

            def program(p, c, t, at):
                return decode_fwd(p, c, t, at).redistribute(mesh, data)

            step = self._compile(program, mesh)
            self._fn = lambda: local(step(params, cache, tok, pos))
        else:
            cache = dtensor_cache(cfg, B, self.m, mesh, self.device)
            tokens = batch_rows(prompt)

            def program(p, c, t):
                return prefill_fwd(p, c, t)[0].redistribute(mesh, data)

            step = self._compile(program, mesh)
            self._fn = lambda: local(step(params, cache, tokens))
        self.runtime.synchronize()
