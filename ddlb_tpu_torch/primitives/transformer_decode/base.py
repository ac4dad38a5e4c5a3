"""TransformerDecode: the flagship model's serving step as a primitive.

The counterpart of the JAX package's ``transformer_decode/base.py``:
autoregressive decode with a KV cache, where one token per sequence
attends an ``m``-long cache and every step re-reads the cache and the
weights, so the numbers that matter are ms per token and tokens/s.

Shape mapping onto ``(m, n, k)``: ``m`` the context length (the cache
fill a decode step is measured at, or the prompt length), ``n`` d_model,
``k`` d_ff. ``phase``: ``decode`` one cached step at position m (the
cache prefilled once at set-up), ``prefill`` the prompt pass, ``generate``
prefill + greedy steps, ``speculate`` the same under greedy speculative
decoding (a ``draft_layers``-deep draft proposes ``spec_k`` tokens, the
target verifies them in one chunk; lossless, so it validates against the
same oracle chain), ``serve`` a drain of the continuous-batching engine.
The option schema is the JAX package's, value for value.
``mlp_kernel=int8|int8_weights`` run the experts' GEMMs on the int8
kernel K7.

Validation pins the step's logits to the single-device teacher-forced
oracle (``models/decode.reference_logits``), generated tokens to its
greedy chain, and the engine's completions to per-slot chains, with the
JAX package's tolerances (:395-618).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.models import decode as dec
from ddlb_tpu_torch.models.transformer import (
    TransformerConfig,
    example_tokens,
    init_params,
    place_params,
)
from ddlb_tpu_torch.primitives.base import Primitive, matmul_precision_scope, torch_dtype

log = logging.getLogger(__name__)

#: full host parameters by (config, experts, seed); a sweep's rows at one
#: width share them, and a full-width set is ~0.5 GB, so few are kept
_HOST_PARAMS: Dict[tuple, dict] = {}
_HOST_PARAMS_KEEP = 2
#: oracle logits by (config, tokens, mesh, seed), one per process
_ORACLE_MEMO: Dict[tuple, np.ndarray] = {}


class TransformerDecode(Primitive):
    """ABC for serving-step implementations."""

    primitive_name = "transformer_decode"

    BASE_OPTIONS = {
        "phase": "decode",
        "batch": 8,
        "vocab": 512,
        "n_heads": 8,
        "n_kv_heads": 0,
        "n_new": 32,
        "n_requests": 0,
        "spec_k": 4,
        "draft_layers": 1,
        "layers": 1,
        "mlp_kernel": "bf16",
        "rope": False,
        "attn_window": 0,
        "kv_cache": "bf16",
        "attn_kernel": "flash",
        "decode_kernel": "einsum",
        "cache_layout": "contiguous",
        "page_size": 128,
        "page_pool_frac": 1.0,
        "dp": 0,
        "tp": 0,
    }
    BASE_ALLOWED = {
        "phase": ["decode", "prefill", "generate", "speculate", "serve"],
        "n_requests": (0, None),
        "batch": (1, None),
        "vocab": (2, None),
        "n_heads": (1, None),
        "n_kv_heads": (0, None),
        "n_new": (1, None),
        "spec_k": (1, None),
        "draft_layers": (1, None),
        "layers": (1, None),
        "mlp_kernel": ["bf16", "int8", "int8_weights"],
        "rope": [True, False],
        "attn_window": (0, None),
        "kv_cache": ["bf16", "int8"],
        "attn_kernel": ["flash", "einsum"],
        "decode_kernel": ["einsum", "pallas"],
        "cache_layout": ["contiguous", "paged"],
        "page_size": (1, None),
        "page_pool_frac": (0.01, 1.0),
        "dp": (0, None),
        "tp": (0, None),
    }

    @property
    def _call_args(self):
        return ()

    def _mesh_factors(self) -> Tuple[int, int]:
        """(dp, tp): explicit options, or tp = 2 where the heads and the
        batch allow and dp the rest (serve: dp = 1)."""
        n = self.runtime.world_size
        dp, tp = self.options["dp"], self.options["tp"]
        if dp and tp:
            if dp * tp != n:
                raise ValueError(f"dp*tp = {dp * tp} != {n} devices")
            return dp, tp
        if dp or tp:
            raise ValueError("set both dp and tp or neither (0 = auto)")
        o = self.options
        if o["phase"] == "serve":
            return 1, n
        tp = 2 if n % 2 == 0 and o["n_heads"] % 2 == 0 and o["batch"] % n == 0 else 1
        return n // tp, tp

    def _check_shapes(self) -> None:
        o = self.options
        dp, tp = self._mesh_factors()
        if self.n % o["n_heads"] != 0:
            raise ValueError(
                f"n={self.n} (d_model) must be divisible by n_heads={o['n_heads']}"
            )
        if o["n_heads"] % tp != 0:
            raise ValueError(f"n_heads={o['n_heads']} not divisible by tp={tp}")
        if o["n_kv_heads"]:
            if o["n_heads"] % o["n_kv_heads"] != 0:
                raise ValueError(
                    f"n_heads={o['n_heads']} not divisible by "
                    f"n_kv_heads={o['n_kv_heads']}"
                )
            if o["n_kv_heads"] % tp != 0:
                raise ValueError(
                    f"n_kv_heads={o['n_kv_heads']} not divisible by tp={tp}"
                )
        if o["batch"] % dp != 0:
            raise ValueError(f"batch={o['batch']} not divisible by dp={dp}")
        if (o["batch"] // dp) % tp != 0:
            raise ValueError(
                f"per-dp batch {o['batch'] // dp} not divisible by tp={tp} "
                f"(the MoE block router)"
            )
        if self.dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError("transformer_decode requires a floating dtype")
        if o["phase"] == "serve" and dp != 1:
            raise ValueError(
                "phase='serve' runs the continuous-batching engine on a "
                "(1, tp) mesh; set dp=1 (one engine per dp shard is how "
                "data parallelism composes)"
            )
        if o["cache_layout"] == "paged" and o["phase"] != "serve":
            raise ValueError(
                "cache_layout='paged' is the serving engine's pool "
                "(phase='serve'); the fixed-shape phases measure the "
                "contiguous layout"
            )
        if o["cache_layout"] != "paged":
            dead = {"page_size", "page_pool_frac"} & self._options_manager.overridden
            if dead:
                raise ValueError(
                    f"Option(s) {sorted(dead)} have no effect with "
                    "cache_layout='contiguous'"
                )

    # -- counts ----------------------------------------------------------------

    def flops(self) -> float:
        """Matmul FLOPs of one measured call (the JAX package's census,
        :201): decode per token ``L (8 D^2 + 4 m D + 4 D F) + 2 D V`` (GQA
        shrinks the k/v projections) times the batch; prefill the causal
        census over the m prompt tokens; generate one prefill plus ``n_new
        - 1`` steps; serve the useful work of the drained workload."""
        o = self.options
        D, Fd = self.n, self.k
        L, B, V = o["layers"], o["batch"], o["vocab"]
        kv_frac = (o["n_kv_heads"] or o["n_heads"]) / o["n_heads"]
        proj = (4.0 + 4.0 * kv_frac) * D * D
        if o["phase"] == "decode":
            per_token = L * (proj + 4.0 * self.m * D + 4.0 * D * Fd)
            return B * (per_token + 2.0 * D * V)
        if o["phase"] == "serve":
            total = 0.0
            for prompt, max_new in self._serve_workload():
                S0 = prompt.size
                total += S0 * (L * (proj + 2.0 * S0 * D + 4.0 * D * Fd))
                total += 2.0 * D * V
                steps = max_new - 1
                ctx_sum = steps * S0 + steps * (steps - 1) / 2.0
                total += (
                    steps * (L * (proj + 4.0 * D * Fd) + 2.0 * D * V)
                    + L * 4.0 * D * ctx_sum
                )
            return total
        prefill = (
            B * self.m * (L * (proj + 2.0 * self.m * D + 4.0 * D * Fd))
            + B * 2.0 * D * V
        )
        if o["phase"] == "prefill":
            return prefill
        steps = o["n_new"] - 1
        ctx_sum = steps * self.m + steps * (steps - 1) / 2.0
        return prefill + B * (
            steps * (L * (proj + 4.0 * D * Fd) + 2.0 * D * V)
            + L * 4.0 * D * ctx_sum
        )

    def hbm_bytes(self) -> float:
        """Device-memory traffic floor of one measured call, in bytes: each
        pass (a decode step, or the prefill) reads the weights and the KV
        cache (``utils/hbm_budget.decode_budget``); generate pays ``n_new``
        passes, serve one per generated token of the drained workload;
        speculate the target's passes when every proposal is accepted,
        ``ceil(n_new / (spec_k + 1))`` (the draft's are overhead, :261)."""
        from ddlb_tpu_torch.utils.hbm_budget import decode_budget

        o = self.options
        census = decode_budget(
            ctx=self.m, d_model=self.n, d_ff=self.k, vocab=o["vocab"],
            n_heads=o["n_heads"], batch=o["batch"], n_kv_heads=o["n_kv_heads"],
            layers=o["layers"], kv_cache=o["kv_cache"],
            mlp_kernel=o["mlp_kernel"],
            phase="generate" if o["phase"] == "speculate" else o["phase"],
            n_new=o["n_new"], spec_k=o["spec_k"], draft_layers=o["draft_layers"],
        )
        per_pass = census["weights"] + census["kv_cache"]
        if o["phase"] in ("decode", "prefill"):
            return per_pass
        if o["phase"] == "serve":
            return sum(mx for _, mx in self._serve_workload()) * per_pass
        if o["phase"] == "speculate":
            return -(-o["n_new"] // (o["spec_k"] + 1)) * per_pass
        return o["n_new"] * per_pass

    def extra_row_fields(self) -> dict:
        """The row's ``hbm_bytes()`` floor beside its time, so a reader of
        the row can take the share of it the measured call reached."""
        return {"hbm_bytes": self.hbm_bytes()}

    # -- model, parameters, tokens ---------------------------------------------

    def _model_config(self) -> TransformerConfig:
        o = self.options
        return TransformerConfig(
            vocab=o["vocab"], d_model=self.n, n_heads=o["n_heads"],
            n_kv_heads=o["n_kv_heads"], d_ff=self.k,
            layers_per_stage=o["layers"], mlp_kernel=o["mlp_kernel"],
            rope=o["rope"], attn_window=o["attn_window"],
            kv_cache=o["kv_cache"], attn_kernel=o["attn_kernel"],
            decode_kernel=o["decode_kernel"], cache_layout=o["cache_layout"],
            page_size=o["page_size"], dtype=torch_dtype(self.dtype),
        )

    def _host_params(self, tp: int, cfg: TransformerConfig = None,
                     seed: int = None) -> dict:
        """The full parameters on the host (every head and expert) of
        ``cfg`` (default: the row's model) from ``seed`` (default: the
        row's), memoised: every rank and the oracle start from them."""
        cfg = cfg or self._model_config()
        seed = self.seed if seed is None else seed
        key = (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_ff,
               cfg.layers_per_stage, cfg.dtype, cfg.mlp_kernel, tp, seed)
        if key not in _HOST_PARAMS:
            while len(_HOST_PARAMS) >= _HOST_PARAMS_KEEP:
                _HOST_PARAMS.pop(next(iter(_HOST_PARAMS)))
            _HOST_PARAMS[key] = init_params(cfg, pp=1, n_experts=tp, seed=seed)
        return _HOST_PARAMS[key]

    def _serve_workload(self):
        """The deterministic phase=serve request list (:340): ``n_requests``
        prompts of length m, ``max_new`` cycling through ``[1, n_new]``."""
        cached = getattr(self, "_serve_workload_memo", None)
        if cached is not None:
            return cached
        o = self.options
        n_req = o["n_requests"] or 2 * o["batch"]
        prompts, _ = example_tokens(n_req, self.m, o["vocab"], seed=self.seed)
        self._serve_workload_memo = [
            (prompts[i], 1 + ((i + 3) % o["n_new"])) for i in range(n_req)
        ]
        return self._serve_workload_memo

    def _host_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        """(prompt [B, m], next token [B]), seeded."""
        tokens, targets = example_tokens(
            self.options["batch"], self.m, self.options["vocab"], seed=self.seed
        )
        return tokens, targets[:, -1]

    def _dp_rows(self) -> slice:
        b = self.options["batch"] // self.mesh.dp
        return slice(self.mesh.dp_rank * b, (self.mesh.dp_rank + 1) * b)

    # -- the oracle --------------------------------------------------------------

    def _reference(self, tokens: np.ndarray) -> np.ndarray:
        """``reference_logits`` over ``tokens [B, S]`` on this rank's device
        with the full parameters, under the dtype's precision scope."""
        cfg = self._model_config()
        dp, tp = self._mesh_factors()
        if tp == 1:
            params = self.params  # the rank holds every head and expert
        else:
            if getattr(self, "_full_params", None) is None:
                self._full_params = place_params(self._host_params(tp), self.device)
            params = self._full_params
        with matmul_precision_scope(self.dtype):
            logits = dec.reference_logits(
                params, torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device),
                cfg, tp=tp, dp=dp,
            )
        return logits.cpu().numpy()

    def _oracle_logits(self) -> np.ndarray:
        """Teacher-forced logits at the measured position (decode: m;
        prefill: m - 1), memoised."""
        prompt, nxt = self._host_tokens()
        if self.options["phase"] == "decode":
            toks = np.concatenate([prompt, nxt[:, None]], axis=1)
        else:
            toks = prompt
        key = (self._model_config(), self._mesh_factors(), self.seed, toks.shape,
               toks.tobytes())
        if key not in _ORACLE_MEMO:
            _ORACLE_MEMO.clear()
            _ORACLE_MEMO[key] = self._reference(toks)
        return _ORACLE_MEMO[key]

    # -- validation ----------------------------------------------------------------

    def _tie_tol(self) -> float:
        tie_tol = 2e-4 if self.dtype == "float32" else 4e-2
        if self.options["kv_cache"] == "int8":
            tie_tol = max(tie_tol, 2e-2)
        return tie_tol

    def validate(self, result) -> bool:
        """Logits (decode, prefill) against the oracle at the same position
        on this rank's rows, rtol 0 and atol 1e-4 (f32) or 2e-2 (half),
        2.5 times that with an int8 MLP in half precision, at least 1e-2
        with an int8 cache; generated tokens and served completions
        against the oracle's greedy chains."""
        self.runtime.synchronize()
        phase = self.options["phase"]
        if phase == "serve":
            return self._validate_serve()
        if phase in ("generate", "speculate"):
            # speculate is lossless: its tokens sit on the same oracle chain
            if isinstance(result, tuple):
                result = result[0]
            return self._validate_generate(result)
        got = result.float().cpu().numpy()
        expected = self._oracle_logits().astype(np.float32)[self._dp_rows()]
        atol = 1e-4 if self.dtype == "float32" else 2e-2
        if self.options["mlp_kernel"] != "bf16" and self.dtype != "float32":
            # half-precision noise upstream of the MLP can flip an int8
            # rounding at a quantization boundary: up to a quantization
            # step between the step and the oracle (JAX :420-430)
            atol *= 2.5
        if self.options["kv_cache"] == "int8":
            atol = max(atol, 1e-2)
        if got.shape != expected.shape:
            log.warning("validation FAILED: shape %s != %s", got.shape, expected.shape)
            return False
        if np.allclose(got, expected, rtol=0.0, atol=atol):
            return True
        log.warning(
            "validation FAILED for %s rank %d: max|err|=%.3e > atol=%.3e",
            type(self).__name__, self.rank,
            float(np.max(np.abs(got - expected))), atol,
        )
        return False

    #: generated tokens pinned to the oracle chain (one forward each)
    _GENERATE_PIN_STEPS = 3
    #: phase=serve: completions pinned per validation
    _SERVE_PIN_REQUESTS = 2

    def _validate_generate(self, result) -> bool:
        """This rank's tokens ``[B/dp, m + n_new]``: the prompt untouched,
        tokens in range, and the first generated tokens on the oracle's
        greedy chain, a mismatch forgiven where the oracle's top-2 gap is
        below the tie tolerance (only the first mismatch of a row counts)."""
        got = result.cpu().numpy()
        prompt, _ = self._host_tokens()
        B, S0 = prompt.shape
        rows = self._dp_rows()
        n_new = self.options["n_new"]
        if got.shape != (rows.stop - rows.start, S0 + n_new):
            log.warning("generate validation FAILED: shape %s", got.shape)
            return False
        pin = min(self._GENERATE_PIN_STEPS, n_new)
        want = np.full((B, pin), -1, np.int64)
        gap = np.zeros((B, pin), np.float32)
        ctx = prompt
        for t in range(pin):
            logits = self._reference(ctx).astype(np.float32)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            gap[:, t] = top2[:, 1] - top2[:, 0]
            want[:, t] = logits.argmax(-1)
            ctx = np.concatenate([ctx, want[:, t:t + 1].astype(np.int32)], axis=1)
        ok = True
        if not (got[:, :S0] == prompt[rows]).all():
            log.warning("generate validation FAILED: prompt mangled")
            ok = False
        if ((got < 0) | (got >= self.options["vocab"])).any():
            log.warning("generate validation FAILED: token range")
            ok = False
        mism = got[:, S0:S0 + pin] != want[rows]
        any_m = mism.any(axis=1)
        first = np.where(any_m, mism.argmax(axis=1), 0)
        row_gap = np.take_along_axis(gap[rows], first[:, None], axis=1)[:, 0]
        hard = any_m & (row_gap >= self._tie_tol())
        if hard.any():
            log.warning(
                "generate validation FAILED: %d rows leave the oracle chain "
                "at a non-tie position", int(hard.sum()),
            )
            ok = False
        return ok

    def _validate_serve(self) -> bool:
        """The first completions of the drain, pinned to the oracle's
        greedy chain of their prompt placed at their slot's batch row
        (the block router's assignment is slot-stable), the first few
        tokens each, with the tie forgiveness of phase=generate."""
        done = getattr(self, "_serve_completions", None)
        if not done:
            log.warning("serve validation FAILED: no completions")
            return False
        workload = self._serve_workload()
        if len(done) != len(workload):
            log.warning(
                "serve validation FAILED: %d completions != %d requests",
                len(done), len(workload),
            )
            return False
        B = self.options["batch"]
        ok = True
        for c in done[:self._SERVE_PIN_REQUESTS]:
            prompt, max_new = workload[c.request_index]
            S0 = prompt.size
            if c.finished_by == "max_new" and c.tokens.size != S0 + max_new:
                log.warning(
                    "serve validation FAILED: request %d length %d != %d",
                    c.request_index, c.tokens.size, S0 + max_new,
                )
                ok = False
                continue
            pin = min(self._GENERATE_PIN_STEPS, c.tokens.size - S0)
            ctx = np.broadcast_to(prompt, (B, S0)).copy()
            for t in range(pin):
                logits = self._reference(ctx).astype(np.float32)[c.slot]
                want = int(logits.argmax())
                if int(c.tokens[S0 + t]) != want:
                    top2 = np.sort(logits)[-2:]
                    if float(top2[1] - top2[0]) >= self._tie_tol():
                        log.warning(
                            "serve validation FAILED: request %d slot %d "
                            "leaves the oracle chain at step %d",
                            c.request_index, c.slot, t,
                        )
                        ok = False
                    break  # past a forgiven tie the contexts differ
                ctx = np.concatenate(
                    [ctx, np.full((B, 1), want, np.int32)], axis=1
                )
        return ok
