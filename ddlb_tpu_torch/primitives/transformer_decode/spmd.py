"""The distributed serving step over a ``(dp, tp)`` mesh of ranks.

The counterpart of the JAX package's ``transformer_decode/spmd.py``: each
rank holds its dp shard of the batch and its tp share of the heads and
experts (``models/transformer.shard_params``) and runs the four phases
(:49-104, :143-194):
- ``decode``: the cache is prefilled to position m once at set-up; one
  measured call is one cached step at m. The step writes its row in
  place at m, the same row with the same values each time, so every
  iteration decodes the same position against the same prefix.
- ``prefill``: the prompt pass that fills the cache.
- ``generate``: prefill + ``n_new`` greedy tokens, one measured call.
- ``speculate``: the same tokens by greedy speculative decoding
  (:105-139): the draft is the model at ``draft_layers`` depth with the
  parameters of ``seed + 1``; one measured call is one whole run, whose
  acceptance counters the row reports (:212-222).
- ``serve``: one drain of the continuous-batching engine over the
  deterministic workload (host-scheduled).
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from ddlb_tpu_torch.models.decode import (
    init_cache,
    make_decode_fn,
    make_generate_fn,
    make_prefill_fn,
    make_speculate_fn,
)
from ddlb_tpu_torch.models.serving import ContinuousBatchingEngine, Request
from ddlb_tpu_torch.models.transformer import place_params, shard_params
from ddlb_tpu_torch.primitives.base import matmul_precision_scope
from ddlb_tpu_torch.primitives.transformer_decode.base import TransformerDecode


class SPMDTransformerDecode(TransformerDecode):
    def _input_setup(self) -> None:
        cfg = self._model_config()
        dp, tp = self._mesh_factors()
        self.mesh = self.runtime.mesh(dp, tp, 1)
        self.num_partitions = dp * tp
        self.params = place_params(
            shard_params(self._host_params(tp), cfg, tp, self.mesh.tp_rank),
            self.device,
        )
        prompt, nxt = self._host_tokens()
        rows = self._dp_rows()
        prompt = torch.from_numpy(prompt[rows].copy()).to(self.device)
        B, phase = self.options["batch"], self.options["phase"]

        if phase == "serve":
            self._fn = self._serve_setup(cfg)
        elif phase == "generate":
            n_new = self.options["n_new"]
            generate = make_generate_fn(self.mesh, cfg, n_new=n_new)
            cache = init_cache(cfg, B, self.m + n_new, self.mesh, self.device)
            self._fn = lambda: generate(self.params, cache, prompt)
        elif phase == "speculate":
            self._fn = self._speculate_setup(cfg, tp, prompt)
        elif phase == "decode":
            decode = make_decode_fn(self.mesh, cfg)
            prefill = make_prefill_fn(self.mesh, cfg)
            cache = init_cache(cfg, B, self.m + 1, self.mesh, self.device)
            with matmul_precision_scope(self.dtype):
                prefill(self.params, cache, prompt)
            tok = torch.from_numpy(nxt[rows].copy()).to(self.device)
            self._fn = lambda: decode(self.params, cache, tok, self.m)[0]
        else:
            prefill = make_prefill_fn(self.mesh, cfg)
            cache = init_cache(cfg, B, self.m, self.mesh, self.device)
            self._fn = lambda: prefill(self.params, cache, prompt)[0]
        self.runtime.synchronize()

    def _speculate_setup(self, cfg, tp, prompt):
        """The draft (same architecture and serving levers at
        ``draft_layers`` depth, parameters from ``seed + 1``), both caches
        sized ``m + n_new + spec_k``, and the run; each call keeps its
        acceptance counters for the row."""
        o = self.options
        n_new, spec_k, B = o["n_new"], o["spec_k"], o["batch"]
        cfg_d = replace(cfg, layers_per_stage=o["draft_layers"])
        params_d = place_params(
            shard_params(self._host_params(tp, cfg_d, self.seed + 1), cfg_d, tp,
                         self.mesh.tp_rank),
            self.device,
        )
        spec = make_speculate_fn(self.mesh, cfg, cfg_d, n_new=n_new, spec_k=spec_k,
                                 with_stats=True)
        horizon = self.m + n_new + spec_k
        cache = init_cache(cfg, B, horizon, self.mesh, self.device)
        cache_d = init_cache(cfg_d, B, horizon, self.mesh, self.device)

        def run():
            tokens, self._spec_stats = spec(self.params, params_d, cache, cache_d, prompt)
            return tokens

        return run

    def _serve_setup(self, cfg):
        """The engine sized for the workload (a paged pool
        ``page_pool_frac`` of contiguous parity), and the drain."""
        o = self.options
        workload = self._serve_workload()
        max_need = max(p.size + mn for p, mn in workload)
        num_pages = None
        if cfg.cache_layout == "paged":
            ps = cfg.page_size
            max_need = -(-max_need // ps) * ps
            num_pages = max(
                1, math.ceil(o["page_pool_frac"] * o["batch"] * (max_need // ps))
            )
        self._engine = eng = ContinuousBatchingEngine(
            self.mesh, cfg, self.params, max_batch=o["batch"],
            max_len=max_need, num_pages=num_pages,
        )

        def run_workload():
            eng.reset()
            for prompt, mn in workload:
                eng.submit(Request(prompt, max_new=mn))
            eng.run()
            self._serve_completions = eng.completions
            return eng.cache["k"]

        return run_workload

    def extra_row_fields(self) -> dict:
        """``hbm_bytes``; with phase=speculate the last call's acceptance
        (``spec_accept_rate = accepted / proposals``, both clipped to
        ``n_new``, so an identical draft measures 1.0; the JAX member runs
        the measured call once more for them, the port keeps the last
        call's); with phase=serve the engine's drain stats (occupancy;
        deferrals and peak pages, the paged pool's pressure; decode ticks
        and tokens generated, which give ms per step and tokens/s)."""
        out = super().extra_row_fields()
        if self.options["phase"] == "speculate":
            st = self._spec_stats
            out.update({
                "spec_rounds": st["rounds"],
                "spec_proposals": st["proposals"],
                "spec_accept_rate": round(st["accepted"] / max(st["proposals"], 1), 4),
            })
            return out
        if self.options["phase"] != "serve":
            return out
        s = self._engine.stats
        out.update({
            "serve_occupancy": round(s.occupancy, 4),
            "serve_prefix_hits": s.prefix_hits,
            "serve_admissions_deferred": s.admissions_deferred,
            "serve_steps": s.steps,
            "serve_generated": s.generated,
        })
        if self._engine.paged:
            out["serve_peak_pages"] = s.peak_pages_in_use
            out["serve_pages_capacity"] = s.pages_capacity
        return out
