"""The flagship MoE transformer's forward pieces, as the serving paths use
them.

The port of the forward subset of the JAX package's
``models/transformer.py``: ``TransformerConfig`` (:47), ``init_params``
(:184, with the pre-quantized expert weights of ``int8_weights``), the
per-rank slicing that ``param_specs`` (:235) expresses, ``apply_rope``
(:285), ``_rms_norm`` (:307), ``_causal_attention`` (:313),
``_flash_full`` (:426, on the port's own flash kernels K8a/K8b),
``_moe_ffn`` (:474, every ``mlp_kernel``; the int8 GEMMs on K7) and
``example_tokens`` (:1224). The training step (with the straight-through
backward of ``mlp_kernel=int8``), the ring attention and the learned
routers are not ported.

Parameters are a plain dict of tensors in the JAX package's layout:
stage-stacked on a leading ``pp = 1`` axis, ``w_qkv [1, L, 3, D, D]``
(MHA) or ``w_q [1, L, D, D]`` + ``w_kv [1, L, 2, D, kv_dim]`` (GQA),
``w_o [1, L, D, D]``, ``moe_w1 [1, L, E, D, F]``, ``moe_w2 [1, L, E, F,
D]``, norms, ``embed [V, D]`` and ``head [D, V]``; under
``mlp_kernel='int8_weights'`` the two expert weights are int8 with float32
``moe_w1_scale [1, L, E, 1, F]`` and ``moe_w2_scale [1, L, E, 1, D]``.
One rank's slice over a ``(dp, tp)`` mesh keeps its tp block of the q/k/v
columns and of the ``w_o`` rows and its one expert with its scales
(``shard_params``).

Rounding. Products take operands in the model dtype and sum in float32
(``torch.matmul``; on the card cuBLAS, as XLA does). Where the JAX
package keeps a float32 product for a later step, the port does the
same for the logits (a float32 product), and otherwise rounds the
product to the model dtype first: the attention output projection is
rounded before its tp sum (which then runs in float32), and the first
MLP product before the activation (on the int8 branches the first
product comes out of the int8 GEMM in float32 and reaches the activation
unrounded, as in the JAX package). In float32 the two packages compute
the same function; in bf16 these extra roundings are within the
family's logits tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ddlb_tpu_torch.ops.flash_attention import flash_attention
from ddlb_tpu_torch.ops.quantized_matmul import (
    int8_matmul_kernel,
    quantize_colwise,
    quantize_rowwise,
    quantize_weight_stack,
)
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy

LN_EPS = 1e-6
#: additive mask sentinel (large-negative, not -inf, as the JAX package)
NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    """The serving subset of the JAX package's ``TransformerConfig``
    (:47-181), with the same names, defaults and construction checks;
    ``dtype`` is a torch dtype."""

    vocab: int = 64
    d_model: int = 32
    n_heads: int = 4
    #: 0 = MHA; fewer = grouped-query attention (GQA)
    n_kv_heads: int = 0
    d_ff: int = 64
    layers_per_stage: int = 1
    #: prefill attention engine: "flash" (K8a/K8b) or "einsum"
    attn_kernel: str = "flash"
    #: "bf16" (the MLP in the model dtype); "int8" (both operands of each
    #: expert GEMM quantized at every call, the int8 GEMM K7);
    #: "int8_weights" (expert weights quantized once by ``init_params``,
    #: activations per call)
    mlp_kernel: str = "bf16"
    #: sliding-window span (0 = full causal)
    attn_window: int = 0
    rope: bool = False
    rope_theta: float = 10000.0
    #: single-token cache attention: "einsum" or "pallas" (the fused
    #: kernels K11/K12, ``ops/decode_attention.py``)
    decode_kernel: str = "einsum"
    #: K/V cache precision: "bf16" (the model dtype) or "int8"
    kv_cache: str = "bf16"
    #: "contiguous" or "paged" (the serving engine's page pool)
    cache_layout: str = "contiguous"
    page_size: int = 128
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}"
            )
        if self.cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown cache_layout '{self.cache_layout}'")
        if self.cache_layout == "paged" and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        h_kv = self.n_kv_heads or self.n_heads
        assert self.n_heads % h_kv == 0, (
            f"n_heads={self.n_heads} not divisible by n_kv_heads={h_kv}"
        )
        return h_kv

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


MLP_KERNELS = ("bf16", "int8", "int8_weights")


def check_mlp_kernel(mlp_kernel: str) -> None:
    """Raise unless ``mlp_kernel`` is one of ``MLP_KERNELS``."""
    if mlp_kernel not in MLP_KERNELS:
        raise ValueError(f"unknown mlp_kernel '{mlp_kernel}'")


def init_params(
    cfg: TransformerConfig, pp: int, n_experts: int, seed: int = 0
) -> Params:
    """Seeded host parameters (CPU tensors in ``cfg.dtype``): the JAX
    package's draws (``rng.normal`` in float64, in the same order), bit
    for bit in float32. For a half dtype the float64 draw is rounded to
    float32 first, then to the dtype. Under ``int8_weights`` the expert
    weights are then quantized per output feature (JAX :222-231, an
    eager call there, hence ``eager=True``)."""
    check_mlp_kernel(cfg.mlp_kernel)
    rng = np.random.default_rng(seed)
    D, Fd, L, V = cfg.d_model, cfg.d_ff, cfg.layers_per_stage, cfg.vocab

    def normal(shape, scale):
        host = rng.normal(0.0, scale, shape).astype(np.float32)
        return torch.from_numpy(host).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype)

    s_in = (1.0 / D) ** 0.5
    s_ff = (1.0 / Fd) ** 0.5
    params = {
        "embed": normal((V, D), 1.0),
        "w_o": normal((pp, L, D, D), s_in),
        "moe_w1": normal((pp, L, n_experts, D, Fd), s_in),
        "moe_w2": normal((pp, L, n_experts, Fd, D), s_ff),
        "ln1": ones((pp, L, D)),
        "ln2": ones((pp, L, D)),
        "ln_f": ones((D,)),
        "head": normal((D, V), s_in),
    }
    if cfg.kv_heads == cfg.n_heads:
        params["w_qkv"] = normal((pp, L, 3, D, D), s_in)
    else:
        params["w_q"] = normal((pp, L, D, D), s_in)
        params["w_kv"] = normal((pp, L, 2, D, cfg.kv_dim), s_in)
    if cfg.mlp_kernel == "int8_weights":
        for name in ("moe_w1", "moe_w2"):
            params[name], params[f"{name}_scale"] = quantize_weight_stack(
                params[name], eager=True
            )
    return params


def _leaf_dtype(name: str, cfg: TransformerConfig) -> torch.dtype:
    """A parameter's dtype: the int8 expert weights and their float32
    scales under ``int8_weights``, ``cfg.dtype`` for every other leaf."""
    if name.endswith("_scale"):
        return torch.float32
    if cfg.mlp_kernel == "int8_weights" and name in ("moe_w1", "moe_w2"):
        return torch.int8
    return cfg.dtype


def params_from_numpy(params, cfg: TransformerConfig, device="cuda") -> Params:
    """A JAX parameter dict pulled to the host (``{name: np.ndarray}``,
    bf16 as ml_dtypes' bfloat16) as this package's parameters, bit for
    bit, on ``device``: each in ``cfg.dtype``, except the int8 expert
    weights and their float32 scales."""
    return {
        name: _tensor_from_numpy(arr).to(device).to(_leaf_dtype(name, cfg))
        for name, arr in params.items()
    }


def shard_params(params: Params, cfg: TransformerConfig, tp: int,
                 tp_rank: int) -> Params:
    """One tp rank's slice of the full parameters, as the JAX package's
    ``param_specs`` (:235-282) shard them over 'tp': the rank's block of
    the q/k/v projection columns (heads) and of the output-projection
    rows, and its one expert with its int8 scales; everything else whole.
    Views, no copies."""
    if tp == 1:
        return dict(params)

    def cols(x, width):
        return x[..., tp_rank * width:(tp_rank + 1) * width]

    D = cfg.d_model
    out = dict(params)
    out["w_o"] = params["w_o"][:, :, tp_rank * D // tp:(tp_rank + 1) * D // tp]
    for name in ("moe_w1", "moe_w2", "moe_w1_scale", "moe_w2_scale"):
        if name in params:
            out[name] = params[name][:, :, tp_rank:tp_rank + 1]
    if "w_qkv" in params:
        out["w_qkv"] = cols(params["w_qkv"], D // tp)
    else:
        out["w_q"] = cols(params["w_q"], D // tp)
        out["w_kv"] = cols(params["w_kv"], cfg.kv_dim // tp)
    return out


def place_params(params: Params, device) -> Params:
    """Every parameter as a contiguous tensor on ``device``."""
    return {name: p.to(device).contiguous() for name, p in params.items()}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate-half rotary embedding (:285): ``x [..., s, h, dh]``,
    ``positions`` broadcastable to ``x.shape[:-2]``; computed in float32
    and cast back."""
    dh = x.shape[-1]
    assert dh % 2 == 0, f"RoPE needs an even head_dim, got {dh}"
    half = dh // 2
    freqs = theta ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm in float32, cast back (:307)."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + LN_EPS)
    return (h * scale.float()).to(x.dtype)


def causal_attention(q, k, v, window: int = 0) -> torch.Tensor:
    """``[b, S, h, dh]`` causal softmax attention in float32 with the
    ``[b, h, S, S]`` scores in memory (:313); GQA k/v are repeated up to
    the query heads, ``window > 0`` drops keys behind the band."""
    if k.shape[2] != q.shape[2]:
        G = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    S = s.shape[-1]
    rows = torch.arange(S, device=s.device)[:, None]
    cols = torch.arange(S, device=s.device)[None, :]
    mask = rows >= cols
    if window:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_full(q, k, v, window: int = 0) -> torch.Tensor:
    """Batched causal flash attention ``[b, S, h, dh] -> [b, S, h, dh]``
    (:426): the batch merges into the kernel's head axis as ``[S, b*h,
    dh]``, GQA group-aligned since ``(bi*h + qh) // G == bi*h_kv + qh //
    G``. On the card this is K8a (no window) or K8b."""
    b, S, h, dh = q.shape

    def merge(x):
        return x.transpose(0, 1).reshape(S, b * x.shape[2], dh).contiguous()

    o = flash_attention(
        merge(q), merge(k), merge(v), scale=1.0 / float(np.sqrt(dh)),
        window=window,
    )
    return o.reshape(S, b, h, dh).transpose(0, 1)


def ffn_scales(params: Params, l: int, e: int, cfg: TransformerConfig):
    """Expert e's ``(w1_scale, w2_scale)`` at layer l under
    ``int8_weights``, else None (JAX ``decode._ffn_scales``)."""
    if cfg.mlp_kernel != "int8_weights":
        return None
    return params["moe_w1_scale"][0, l, e], params["moe_w2_scale"][0, l, e]


def moe_ffn(tokens2d: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            mlp_kernel: str, out_dtype: torch.dtype, scales=None) -> torch.Tensor:
    """One expert's FFN on a ``[T, D]`` slab (:474): ``gelu`` (tanh form,
    JAX's default) of the first product, then the second.

    ``int8``: each product quantizes its activation per row and its
    weight per column and runs the int8 GEMM (K7); ``int8_weights``: the
    weights are the pre-quantized int8 leaves with ``scales`` = ``(w1_scale,
    w2_scale)``, the activations are quantized per row. On both int8
    branches the first product comes out in float32 and is rounded to
    ``out_dtype`` only after the activation. Per-row and per-column
    scales are local to a row or a column, so the result of a row does
    not depend on how rows are batched: the sharded step and the oracle
    agree exactly.
    """
    check_mlp_kernel(mlp_kernel)
    if mlp_kernel == "bf16":
        z = F.gelu(torch.matmul(tokens2d, w1).float(), approximate="tanh")
        return torch.matmul(z.to(out_dtype), w2).to(out_dtype)
    if mlp_kernel == "int8":
        (w1, s1), (w2, s2) = quantize_colwise(w1), quantize_colwise(w2)
    elif scales is None:
        raise ValueError(
            "mlp_kernel='int8_weights' needs the (w1_scale, w2_scale) pair "
            "that init_params emits beside the int8 weights"
        )
    else:
        s1, s2 = scales
    qx, sx = quantize_rowwise(tokens2d)
    z = F.gelu(int8_matmul_kernel(qx, w1, sx, s1, out_dtype=torch.float32),
               approximate="tanh").to(out_dtype)
    qz, sz = quantize_rowwise(z)
    return int8_matmul_kernel(qz, w2, sz, s2, out_dtype=out_dtype)


def example_tokens(batch: int, seq: int, vocab: int,
                   seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Random token stream and its next-token targets (:1224), int32
    host arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
