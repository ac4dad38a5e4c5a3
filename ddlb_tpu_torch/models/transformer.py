"""The flagship MoE transformer: its serving pieces and its training step.

The port of the JAX package's ``models/transformer.py``:
``TransformerConfig`` (:47), ``init_params`` (:184, any number of stages,
with the pre-quantized expert weights of ``int8_weights``), ``param_specs``
(:235) as ``param_axes`` and ``shard_params``, ``apply_rope`` (:285),
``_rms_norm`` (:307), ``_causal_attention`` (:313), ``_ring_attention``
(:338), ``_flash_full`` (:426, on K8a/K8b and the K10 backward),
``_ring_flash`` (:450, K9 and K10 around the tp ring), ``_moe_ffn`` (:474,
every ``mlp_kernel``; the int8 GEMMs on K7, differentiable through the
straight-through estimator), ``_ce_loss`` (:517), ``make_stage_fn``
(:628), ``make_loss_fn`` (:866, the GPipe loop at any pp),
``make_train_step`` (:980, with an AdamW as ``optax.adamw``'s),
``reference_loss`` (:1033) and ``example_tokens`` (:1224). The learned
routers (``router=topk|expert_choice``) and the 1F1B and interleaved
pipeline schedules (``models/pipeline.py``) are not ported.

Parameters are a plain dict of tensors in the JAX package's layout:
stage-stacked on a leading ``pp`` axis, ``w_qkv [pp, L, 3, D, D]`` (MHA)
or ``w_q [pp, L, D, D]`` + ``w_kv [pp, L, 2, D, kv_dim]`` (GQA),
``w_o [pp, L, D, D]``, ``moe_w1 [pp, L, E, D, F]``, ``moe_w2 [pp, L, E, F,
D]``, norms, ``embed [V, D]`` and ``head [D, V]``; under
``mlp_kernel='int8_weights'`` the two expert weights are int8 with float32
``moe_w1_scale [pp, L, E, 1, F]`` and ``moe_w2_scale [pp, L, E, 1, D]``.
One rank's slice over a ``(dp, tp, pp)`` mesh keeps its stage, its tp
block of the q/k/v columns and of the ``w_o`` rows (whole under ring
attention) and its one expert with its scales (``shard_params``).

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
family's tolerances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ddlb_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    ring_chunk_live,
    ring_flash_attention,
)
from ddlb_tpu_torch.ops.quantized_matmul import (
    int8_matmul_kernel,
    int8_ste_matmul,
    quantize_rowwise,
    quantize_weight_stack,
)
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy

LN_EPS = 1e-6

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's ``TransformerConfig`` (:47-181) without the learned
    routers' knobs, with the same names, defaults and construction checks;
    ``dtype`` is a torch dtype."""

    vocab: int = 64
    d_model: int = 32
    n_heads: int = 4
    #: 0 = MHA; fewer = grouped-query attention (GQA)
    n_kv_heads: int = 0
    d_ff: int = 64
    layers_per_stage: int = 1
    #: GPipe microbatches per dp rank of the training step
    microbatches: int = 2
    #: the training step's attention: "gathered" (all-gather the sequence
    #: over tp, heads sharded) or "ring" (context parallelism: K/V chunks
    #: ride the tp ring, attention weights replicated)
    attention: str = "gathered"
    #: attention engine: "flash" (K8a/K8b forward, K10 backward; K9 on the
    #: ring) or "einsum"
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
    #: MoE routing: "block" (balanced block routing); the learned routers
    #: of the JAX package are not ported (ROADMAP.md)
    router: str = "block"
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


#: leaves without a stage axis (replicated over pp)
_UNSTAGED = ("embed", "head", "ln_f")


def param_axes(cfg: TransformerConfig, names) -> Dict[str, Dict[str, int]]:
    """``param_specs`` (:235-282) as ``{name: {mesh axis: sharded dim}}``:
    the stage axis (dim 0) on pp for every stage-stacked leaf; on tp the
    experts with their scales (dim 2), the output-projection rows (dim 2)
    and the q/k/v projection columns, except under ``attention='ring'``,
    which replicates the attention projections (tp is then the context
    axis). embed, head and ln_f are replicated, and nothing is sharded on
    dp."""
    ring = cfg.attention == "ring"
    tp_dims = {"moe_w1": 2, "moe_w2": 2, "moe_w1_scale": 2, "moe_w2_scale": 2}
    if not ring:
        tp_dims.update({"w_o": 2, "w_qkv": 4, "w_q": 3, "w_kv": 4})
    axes = {}
    for name in names:
        if name in _UNSTAGED:
            axes[name] = {}
            continue
        axes[name] = {"pp": 0}
        if name in tp_dims:
            axes[name]["tp"] = tp_dims[name]
    return axes


def shard_params(params: Params, cfg: TransformerConfig, tp: int,
                 tp_rank: int, pp: int = 1, pp_rank: int = 0) -> Params:
    """One rank's slice of the full parameters over the (tp, pp) axes, as
    ``param_axes`` shards them: its stage of the stage stack, its block of
    the q/k/v columns (heads) and output-projection rows (not under ring
    attention), and its one expert with its int8 scales. Views, no
    copies."""
    out = {}
    ranks, sizes = {"tp": tp_rank, "pp": pp_rank}, {"tp": tp, "pp": pp}
    for name, axes in param_axes(cfg, params).items():
        x = params[name]
        for axis, dim in axes.items():
            if sizes[axis] > 1:
                width = x.shape[dim] // sizes[axis]
                x = x.narrow(dim, ranks[axis] * width, width)
        out[name] = x
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
    weight per column and runs the int8 GEMM (K7), differentiable by the
    straight-through estimator (``int8_ste_matmul``); ``int8_weights``: the
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
        # the straight-through product: K7 forward, a float32 gradient
        z = F.gelu(int8_ste_matmul(tokens2d, w1), approximate="tanh")
        return int8_ste_matmul(z.to(out_dtype), w2).to(out_dtype)
    if scales is None:
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


# -- the training step -----------------------------------------------------------

ATTENTIONS = ("gathered", "ring")


def check_train_config(cfg: TransformerConfig) -> None:
    """Raise on what the training path does not take: an unknown attention
    or kernel, and the parts of the JAX package not ported yet (the learned
    routers; ``int8_weights``, whose int8 leaves have no gradient)."""
    if cfg.attention not in ATTENTIONS:
        raise ValueError(f"unknown attention '{cfg.attention}'")
    if cfg.attn_kernel not in ("flash", "einsum"):
        raise ValueError(f"unknown attn_kernel '{cfg.attn_kernel}'")
    check_mlp_kernel(cfg.mlp_kernel)
    if cfg.mlp_kernel == "int8_weights":
        raise ValueError(
            "mlp_kernel='int8_weights' of the training model is not yet ported "
            "to ddlb_tpu_torch (ROADMAP.md); train with mlp_kernel='int8'"
        )
    if cfg.router != "block":
        raise ValueError(
            f"router='{cfg.router}' is not yet ported to ddlb_tpu_torch "
            "(ROADMAP.md); the port routes with router='block'"
        )


def ring_attention(q, k, v, mesh, window: int = 0) -> torch.Tensor:
    """Context-parallel causal attention in einsum form (:338): this rank's
    ``[b, s_loc, h, dh]`` chunk; K/V chunks ride the tp ring (a
    differentiable hop) into a float32 online-softmax carry, chunks outside
    the live band skipped. GQA chunks are repeated up to the query heads
    before each fold."""
    group = q.shape[2] // k.shape[2]
    d, my = mesh.tp, mesh.tp_rank
    s_loc, dh = q.shape[1], q.shape[3]
    qh = q.float().transpose(1, 2) * (1.0 / float(np.sqrt(dh)))  # [b, h, s, dh]
    acc = torch.zeros_like(qh)
    m = torch.full(qh.shape[:3] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    rows = torch.arange(s_loc, device=q.device)[:, None]
    cols = torch.arange(s_loc, device=q.device)[None, :]
    k_cur, v_cur = k, v
    for t in range(d):
        src = (my - t) % d  # the chunk held after t hops came from src
        if ring_chunk_live(src, my, s_loc, window):
            k_use = k_cur.repeat_interleave(group, 2) if group > 1 else k_cur
            v_use = v_cur.repeat_interleave(group, 2) if group > 1 else v_cur
            s = torch.einsum("bhqd,bkhd->bhqk", qh, k_use.float())
            mask = (my * s_loc + rows) >= (src * s_loc + cols)
            if window:
                mask &= (src * s_loc + cols) > (my * s_loc + rows - window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            if window:
                p = p.masked_fill(~mask, 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_use.float())
            m = m_new
        if t + 1 < d:
            k_cur, v_cur = mesh.tp_ring_shift(k_cur, v_cur)
    return (acc / l).transpose(1, 2).to(q.dtype)


def ring_flash(q, k, v, mesh, window: int = 0) -> torch.Tensor:
    """Batched context-parallel flash attention on this rank's chunk
    (:450): ``[b, s_loc, h, dh]`` with the batch merged into the heads,
    ``ops.flash_attention.ring_flash_attention`` over the tp ring (K9
    forward, K10 backward with the dK/dV accumulators riding the ring)."""
    b, s_loc, h, dh = q.shape

    def merge(x):
        return x.transpose(0, 1).reshape(s_loc, b * x.shape[2], dh).contiguous()

    o = ring_flash_attention(
        merge(q), merge(k), merge(v),
        shift=lambda *ts: mesh.shift("tp", *ts), axis_size=mesh.tp,
        axis_index=mesh.tp_rank, scale=1.0 / float(np.sqrt(dh)), window=window,
    )
    return o.reshape(s_loc, b, h, dh).transpose(0, 1)


def _project(h: torch.Tensor, sp: Params, l: int):
    """q, k, v of ``h`` with layer l's (local) projection weights."""
    if "w_qkv" in sp:
        w = sp["w_qkv"][0, l]
        return tuple(torch.matmul(h, w[i]) for i in range(3))
    return (torch.matmul(h, sp["w_q"][0, l]),
            *(torch.matmul(h, sp["w_kv"][0, l, i]) for i in range(2)))


def make_stage_fn(cfg: TransformerConfig, mesh):
    """The per-stage body ``stage_fn(x, sp) -> x`` (:628-863): this stage's
    L blocks on the local slab ``x [b, S/tp, d_model]``, with ``sp`` the
    rank's parameters (stage axis of size 1). Attention is gathered (the
    sequence all-gathered over tp, the rank's heads projected, flash or
    einsum attention, the output projection reduce-scattered back) or ring
    (replicated projections on the local chunk, the ring flash or einsum
    attention); the MoE FFN routes each slab's tokens in tp equal blocks
    through one all-to-all over tp to the resident expert and back (the
    block router). Every collective here is differentiable."""
    check_train_config(cfg)
    tp, L, dh = mesh.tp, cfg.layers_per_stage, cfg.head_dim
    ring = cfg.attention == "ring"

    def stage_fn(x: torch.Tensor, sp: Params) -> torch.Tensor:
        b, s_loc, D = x.shape
        if sp["moe_w1"].shape[2] != 1:
            raise ValueError(
                f"n_experts must equal tp={tp} (one resident expert per rank); "
                f"got {sp['moe_w1'].shape[2] * tp}"
            )
        for l in range(L):
            h = rms_norm(x, sp["ln1"][0, l])
            if ring:
                q, k, v = _project(h, sp, l)
                q = q.reshape(b, s_loc, cfg.n_heads, dh)
                k = k.reshape(b, s_loc, cfg.kv_heads, dh)
                v = v.reshape(b, s_loc, cfg.kv_heads, dh)
                if cfg.rope:
                    pos = (mesh.tp_rank * s_loc
                           + torch.arange(s_loc, device=x.device))[None]
                    q = apply_rope(q, pos, cfg.rope_theta)
                    k = apply_rope(k, pos, cfg.rope_theta)
                attend = ring_flash if cfg.attn_kernel == "flash" else ring_attention
                attn = attend(q, k, v, mesh, window=cfg.attn_window)
                y = torch.matmul(attn.reshape(b, s_loc, -1), sp["w_o"][0, l])
            else:
                q, k, v = _project(mesh.tp_all_gather(h, 1), sp, l)
                S = q.shape[1]
                q = q.reshape(b, S, cfg.n_heads // tp, dh)
                k = k.reshape(b, S, cfg.kv_heads // tp, dh)
                v = v.reshape(b, S, cfg.kv_heads // tp, dh)
                if cfg.rope:
                    pos = torch.arange(S, device=x.device)[None]
                    q = apply_rope(q, pos, cfg.rope_theta)
                    k = apply_rope(k, pos, cfg.rope_theta)
                if cfg.attn_kernel == "flash":
                    attn = flash_full(q, k, v, window=cfg.attn_window)
                else:
                    attn = causal_attention(q, k, v, window=cfg.attn_window)
                part = torch.matmul(attn.reshape(b, S, -1), sp["w_o"][0, l])
                y = mesh.tp_reduce_scatter(part.float(), 1).to(x.dtype)
            x = x + y
            h = rms_norm(x, sp["ln2"][0, l])
            u = mesh.tp_all_to_all(h.reshape(b * s_loc, D))  # block routing
            u = moe_ffn(u, sp["moe_w1"][0, l, 0], sp["moe_w2"][0, l, 0],
                        cfg.mlp_kernel, x.dtype)
            x = x + mesh.tp_all_to_all(u).reshape(b, s_loc, D)
        return x

    return stage_fn


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32 (:517)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long()).mean()


def _check_step_shapes(cfg: TransformerConfig, mesh, tokens: torch.Tensor) -> None:
    """The static-shape contract of the loss body (:889-905)."""
    B_loc, S = tokens.shape
    tp, mb = mesh.tp, cfg.microbatches
    if B_loc % mb:
        raise ValueError(f"per-dp-rank batch {B_loc} not divisible by microbatches={mb}")
    if S % tp:
        raise ValueError(f"sequence {S} not divisible by tp={tp}")
    if cfg.attention != "ring" and cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
    if cfg.attention != "ring" and cfg.kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.kv_heads} not divisible by tp={tp}")
    if (B_loc // mb) * (S // tp) % tp:
        raise ValueError(
            "per-microbatch local tokens must divide by tp for the MoE block router"
        )


def _gpipe(mesh, cfg: TransformerConfig, stage_fn, params: Params,
           tokens: torch.Tensor, targets: torch.Tensor, with_grads: bool):
    """The GPipe loop of the loss (:928-962) and, with ``with_grads``, its
    backward: returns ``(loss, grads)``, ``grads`` None without.

    ``tokens``/``targets`` are this dp rank's ``[B/dp, S]`` rows. Stage 0
    embeds; each tick runs the stage on its microbatch and hands the result
    to the next stage (``Mesh.pp_shift``); the last stage takes the head
    and the cross-entropy. Ticks in which a stage holds no microbatch (the
    pipeline's bubble) run nothing and hand on zeros. The loss is summed
    over pp and averaged over dp and tp, as the JAX package's psums do.

    The backward is the forward's ticks in reverse, each stage's gradient
    handed back to the previous stage (the hop's transpose), with every
    stage's blocks recomputed from its input (``torch.utils.checkpoint``,
    as ``jax.checkpoint`` does, :863). Each tick is one
    ``torch.autograd.grad`` call: no ``.grad`` accumulates on any tensor,
    and the parameters given are left as they are. The gradient is that of
    the global loss, seeded with ``1 / (microbatches * dp * tp)`` on each
    last-stage tick, and the gradient of each leaf is summed over the mesh
    axes that replicate it (dp always; tp and pp where ``param_axes`` does
    not shard it).
    """
    _check_step_shapes(cfg, mesh, tokens)
    dp, tp, pp, mb = mesh.dp, mesh.tp, mesh.pp, cfg.microbatches
    p_tp, p_pp = mesh.tp_rank, mesh.pp_rank
    B_loc, S = tokens.shape
    s_loc, b_mb = S // tp, B_loc // mb
    last = p_pp == pp - 1
    ticks = mb + pp - 1
    leaves = ({name: t.detach().requires_grad_(True) for name, t in params.items()}
              if with_grads else params)
    device, D = tokens.device, cfg.d_model

    def local(x, i):
        return x[i * b_mb:(i + 1) * b_mb, p_tp * s_loc:(p_tp + 1) * s_loc]

    def run(x):
        if with_grads:
            return checkpoint(stage_fn, x, leaves, use_reentrant=False)
        return stage_fn(x, leaves)

    def zeros():
        return torch.zeros((b_mb, s_loc, D), dtype=cfg.dtype, device=device)

    record = []
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    buf = zeros()
    with torch.enable_grad() if with_grads else torch.no_grad():
        for t in range(ticks):
            x_in = y = loss_t = None
            if p_pp <= t < p_pp + mb:
                if p_pp == 0:
                    x_in = leaves["embed"][local(tokens, t).long()]
                else:
                    x_in = buf.detach().requires_grad_(with_grads)
                y = run(x_in)
                if last:
                    h = rms_norm(y, leaves["ln_f"])
                    logits = torch.matmul(h.float(), leaves["head"].float())
                    loss_t = ce_loss(logits, local(targets, t - (pp - 1)))
                    loss_acc = loss_acc + loss_t.detach()
            record.append((x_in, y, loss_t))
            if pp > 1 and t + 1 < ticks:
                buf = mesh.pp_shift(zeros() if y is None else y.detach())
    loss = mesh.axis_sum(loss_acc / mb, "pp")
    loss = mesh.axis_sum(loss, "dp") / dp
    loss = mesh.axis_sum(loss, "tp") / tp
    if not with_grads:
        return loss, None

    names = list(leaves)
    wrt = [leaves[name] for name in names]
    grads = dict.fromkeys(names)
    seed = torch.tensor(1.0 / (mb * dp * tp), dtype=torch.float32, device=device)
    g_in = None  # the gradient of this stage's input at tick t + 1
    for t in reversed(range(ticks)):
        x_in, y, loss_t = record[t]
        g_y = None
        if pp > 1 and t + 1 < ticks:
            g_y = mesh.pp_shift(zeros() if g_in is None else g_in, reverse=True)
        g_in = None
        if y is None:
            continue
        outputs, seeds = [], []
        if not last:
            outputs.append(y)
            seeds.append(g_y)
        if loss_t is not None:
            outputs.append(loss_t)
            seeds.append(seed)
        inputs = wrt + ([x_in] if p_pp > 0 else [])
        got = torch.autograd.grad(outputs, inputs, seeds, allow_unused=True)
        for name, g in zip(names, got):
            if g is not None:
                grads[name] = g if grads[name] is None else grads[name] + g
        if p_pp > 0:
            g_in = got[-1]
    axes = param_axes(cfg, names)
    for name in names:
        g = grads[name] if grads[name] is not None else torch.zeros_like(params[name])
        grads[name] = mesh.axis_sum(
            g, "dp", *(a for a in ("tp", "pp") if a not in axes[name])
        )
    return loss, grads


def make_loss_fn(mesh, cfg: TransformerConfig):
    """The loss of the flagship model over a ``(dp, tp, pp)`` mesh (:866):
    ``loss_fn(params, tokens, targets)`` on this rank's parameters
    (``shard_params``) and its dp rows of the tokens; a float32 scalar, the
    same on every rank. No gradient is taken."""
    stage_fn = make_stage_fn(cfg, mesh)

    def loss_fn(params, tokens, targets):
        return _gpipe(mesh, cfg, stage_fn, params, tokens, targets, False)[0]

    return loss_fn


def make_loss_and_grad_fn(mesh, cfg: TransformerConfig):
    """``fn(params, tokens, targets) -> (loss, grads)``: the loss and the
    gradient of the global loss for this rank's parameters (``_gpipe``)."""
    stage_fn = make_stage_fn(cfg, mesh)

    def fn(params, tokens, targets):
        return _gpipe(mesh, cfg, stage_fn, params, tokens, targets, True)

    return fn


def make_train_step(mesh, cfg: TransformerConfig, learning_rate: float = 1e-2):
    """The full training step (:980-1027): ``(train_step, init_opt_state)``
    with ``train_step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)``, the loss taken before the update. Functional: the
    step returns new parameters and optimizer state and leaves its inputs
    as they are, so a benchmark can run it again and again on the same
    operands (the JAX package's ``donate=False``)."""
    grad_fn = make_loss_and_grad_fn(mesh, cfg)

    def train_step(params, opt_state, tokens, targets):
        loss, grads = grad_fn(params, tokens, targets)
        params, opt_state = adamw_update(params, grads, opt_state, learning_rate)
        return params, opt_state, loss

    return train_step, adamw_init


# -- AdamW, as optax.adamw -------------------------------------------------------

#: optax.adamw's defaults beside the learning rate
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def adamw_init(params: Params) -> dict:
    """``optax.adamw(...).init``: a zero step count and zero moments in
    each parameter's dtype."""
    device = next(iter(params.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {name: torch.zeros_like(p) for name, p in params.items()},
        "nu": {name: torch.zeros_like(p) for name, p in params.items()},
    }


def adamw_state_from_numpy(count, mu, nu, cfg: TransformerConfig,
                           device="cuda") -> dict:
    """An ``optax.adamw`` state pulled to the host (its ``ScaleByAdamState``
    count and the ``mu``/``nu`` dicts of numpy arrays) as this package's
    optimizer state on ``device``, bit for bit: a step of the JAX package
    can be continued here."""
    return {
        "count": torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
        "mu": params_from_numpy(mu, cfg, device),
        "nu": params_from_numpy(nu, cfg, device),
    }


def adamw_update(params: Params, grads: Params, state: dict,
                 learning_rate: float = 1e-2):
    """One ``optax.adamw(learning_rate)`` update with optax's defaults (b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4; torch's AdamW decays by
    1e-2), as new tensors: ``(params, state)``; nothing given is changed.
    The moments live in the parameter dtype; the bias corrections ``1 -
    b**count`` are taken in float32 and cast to it, as optax does."""
    count = state["count"] + 1
    powers = torch.tensor([ADAM_B1, ADAM_B2], dtype=torch.float32,
                          device=count.device) ** count.float()
    bc1, bc2 = 1 - powers[0], 1 - powers[1]
    new_params, mu, nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        mu[name] = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][name]
        nu[name] = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * state["nu"][name]
        m_hat = mu[name] / bc1.to(p.dtype)
        v_hat = nu[name] / bc2.to(p.dtype)
        u = m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        u = (u + WEIGHT_DECAY * p) * -learning_rate
        new_params[name] = (p + u).to(p.dtype)
    return new_params, {"count": count, "mu": mu, "nu": nu}


# -- the single-device oracle ------------------------------------------------------


def reference_loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
                   cfg: TransformerConfig, tp: int, dp: int = 1) -> torch.Tensor:
    """The single-device oracle of the training loss (:1033-1221), block
    router only: each ``B / (dp * microbatches)``-row chunk forwarded on its
    own through every stage with einsum attention, each layer's MoE routing
    the tokens of each of the tp sequence shards in tp equal blocks to the
    experts as the tp ranks do, and the chunks' cross-entropies averaged.
    Differentiable (the ``compute_only`` member trains through it)."""
    if cfg.router != "block":
        raise ValueError(f"router='{cfg.router}' is not yet ported to ddlb_tpu_torch")
    B, S = tokens.shape
    b_mb = B // (dp * cfg.microbatches)
    s_loc = S // tp
    pp, L = params["ln1"].shape[:2]
    D, dh = cfg.d_model, cfg.head_dim
    losses = []
    for c0 in range(0, B, b_mb):
        x = params["embed"][tokens[c0:c0 + b_mb].long()]
        for st in range(pp):
            stage = {name: params[name][st:st + 1] for name in params
                     if name not in _UNSTAGED}
            for l in range(L):
                h = rms_norm(x, stage["ln1"][0, l])
                q, k, v = _project(h, stage, l)
                q = q.reshape(b_mb, S, cfg.n_heads, dh)
                k = k.reshape(b_mb, S, cfg.kv_heads, dh)
                v = v.reshape(b_mb, S, cfg.kv_heads, dh)
                if cfg.rope:
                    pos = torch.arange(S, device=x.device)[None]
                    q = apply_rope(q, pos, cfg.rope_theta)
                    k = apply_rope(k, pos, cfg.rope_theta)
                attn = causal_attention(q, k, v, window=cfg.attn_window)
                x = x + torch.matmul(attn.reshape(b_mb, S, D), stage["w_o"][0, l])
                h = rms_norm(x, stage["ln2"][0, l])
                T = b_mb * s_loc
                g = T // tp
                shards = []
                for j in range(tp):
                    blk = h[:, j * s_loc:(j + 1) * s_loc].reshape(T, D)
                    out = [moe_ffn(blk[e * g:(e + 1) * g], stage["moe_w1"][0, l, e],
                                   stage["moe_w2"][0, l, e], cfg.mlp_kernel, x.dtype)
                           for e in range(tp)]
                    shards.append(torch.cat(out).reshape(b_mb, s_loc, D))
                x = x + torch.cat(shards, dim=1)
        h = rms_norm(x, params["ln_f"])
        logits = torch.matmul(h.float(), params["head"].float())
        losses.append(ce_loss(logits, targets[c0:c0 + b_mb]))
    return torch.stack(losses).mean()
