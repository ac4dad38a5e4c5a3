"""Autoregressive decode for the flagship model: KV cache, one-token steps,
prompt prefill, greedy generation and the teacher-forced oracle.

The port of the JAX package's ``models/decode.py``. One process is one
rank of a ``(dp, tp, 1)`` mesh (``runtime.Mesh``) and runs the body that the
JAX package runs under ``shard_map``: its batch shard (over dp), its heads
and its one expert (over tp), with the ``psum`` over 'tp' as
``Mesh.axis_sum`` over 'tp' and the MoE ``all_gather`` as
``Mesh.tp_all_gather_rows``.

- ``init_cache`` / ``init_paged_cache``: this rank's cache, ``[L, B/dp,
  S_max, H_kv/tp, dh]`` (contiguous) or a pool ``[L, P, page_size,
  H_kv/tp, dh]`` plus a replicated page table ``[B, max_pages]`` whose
  sentinel id ``P`` marks an unmapped entry; int8 caches carry float32
  per-(position, head) scales.
- ``make_decode_fn``: one token per sequence against the cache, at one
  position (an int) or per-sequence positions (``ragged=True``, a ``[B]``
  int32 tensor); ``decode_kernel='pallas'`` takes the fused kernels K11
  (contiguous) and K12 (paged) of ``ops/decode_attention.py``.
- ``make_prefill_fn``: the prompt pass that fills the cache; attention on
  the flash kernels K8a/K8b (``attn_kernel='flash'``) or einsum.
- ``make_generate_fn``: prefill, then greedy decode steps.
- ``reference_logits``: the single-device oracle, a teacher-forced full
  forward that shares no attention code with the cache path.

In place, not functional. The JAX functions return a new cache; these
write the given one in place and return it. A decode step writes the row
at its position and then reads rows up to it, so re-running it at the
same position with the same token rewrites the same values and reads the
same prefix: measured iterations stay identical. Drop and fill are
explicit: a ragged or paged write whose position is past the cache, or
whose page is the sentinel, leaves the cache as it was (the JAX
``mode='drop'``), and a read through a sentinel page sees zeros
(``mode='fill'``).

Not ported: the speculative-verify chunk (``make_chunk_decode_fn``, t > 1
cached steps), ``make_speculate_fn``, sampling at ``temperature > 0``,
and the full-width ``make_full_width_fns`` of the GSPMD member.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ddlb_tpu_torch.models.transformer import (
    NEG_INF,
    TransformerConfig,
    apply_rope,
    causal_attention,
    ffn_scales,
    flash_full,
    moe_ffn,
    rms_norm,
)
from ddlb_tpu_torch.ops import decode_attention as da
from ddlb_tpu_torch.primitives.base import _tensor_from_numpy

Cache = Dict[str, torch.Tensor]

KV_QMAX = 127.0


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(position, head) int8 over the feature axis (:69):
    ``x [..., dh] ~ q * s``, ``q`` int8 and ``s [..., 1]`` float32."""
    xf = x.float()
    s = (xf.abs().amax(-1, keepdim=True) / KV_QMAX).clamp_min(1e-30)
    q = torch.clamp(torch.round(xf / s), -KV_QMAX, KV_QMAX).to(torch.int8)
    return q, s


def kv_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize (:79): the value every int8 cache read
    sees, shared by prefill attention and the oracle."""
    q, s = quantize_kv(x)
    return (q.float() * s).to(x.dtype)


def _local(cfg: TransformerConfig, batch: int, mesh):
    """(this rank's batch, its kv heads) under ``cache_specs`` (:125):
    batch over dp, kv heads over tp."""
    if mesh is None:
        return batch, cfg.kv_heads
    if batch % mesh.dp or cfg.kv_heads % mesh.tp:
        raise ValueError(
            f"batch {batch} / kv heads {cfg.kv_heads} do not split over "
            f"dp={mesh.dp}, tp={mesh.tp}"
        )
    return batch // mesh.dp, cfg.kv_heads // mesh.tp


def _zeros(cfg, shape, device) -> Cache:
    if cfg.kv_cache == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), device=device),
        }
    if cfg.kv_cache == "bf16":
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
    raise ValueError(f"unknown kv_cache '{cfg.kv_cache}'")


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, mesh=None,
               device="cuda") -> Cache:
    """This rank's zeroed cache ``[L, B/dp, S_max, H_kv/tp, dh]`` (:87);
    ``batch`` is the global batch."""
    b, h_kv = _local(cfg, batch, mesh)
    shape = (cfg.layers_per_stage, b, max_len, h_kv, cfg.head_dim)
    return _zeros(cfg, shape, device)


def init_paged_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     num_pages: int, mesh=None, device="cuda") -> Cache:
    """This rank's page pool ``[L, P, page_size, H_kv/tp, dh]`` and the
    table ``[batch, max_len // page_size]``, every entry the sentinel
    ``P`` (:141). The pool is shared across slots, so dp must be 1."""
    if max_len % cfg.page_size:
        raise ValueError(
            f"max_len={max_len} not divisible by page_size={cfg.page_size}"
        )
    if mesh is not None and mesh.dp != 1:
        raise ValueError("a paged cache shares one pool over the slots: dp must be 1")
    _, h_kv = _local(cfg, batch, mesh)
    shape = (cfg.layers_per_stage, num_pages, cfg.page_size, h_kv, cfg.head_dim)
    cache = _zeros(cfg, shape, device)
    cache["table"] = torch.full(
        (batch, max_len // cfg.page_size), num_pages, dtype=torch.int32,
        device=device,
    )
    return cache


def cache_from_numpy(cache) -> Cache:
    """A JAX cache dict pulled to the host (``{name: np.ndarray}``) as this
    package's cache on the CPU, bit for bit."""
    return {name: _tensor_from_numpy(arr) for name, arr in cache.items()}


def cache_max_len(cache: Cache) -> int:
    """S_max of either layout (:194)."""
    if "table" in cache:
        return cache["table"].shape[1] * cache["k"].shape[2]
    return cache["k"].shape[2]


def page_coords(cache: Cache, pos: torch.Tensor):
    """Absolute positions ``[b]`` -> ``(pages [b], rows [b])`` through the
    table (:201); a position past the table, or an unmapped entry, maps
    to the sentinel page ``P``."""
    table = cache["table"]
    num_pages, ps = cache["k"].shape[1], cache["k"].shape[2]
    page_idx = pos.long() // ps
    oob = (page_idx < 0) | (page_idx >= table.shape[1])
    safe = page_idx.clamp(0, table.shape[1] - 1)
    pages = table.gather(1, safe[:, None])[:, 0].long()
    pages = torch.where(oob, torch.full_like(pages, num_pages), pages)
    return pages, pos.long() % ps


def project_qkv(h, params, l, b, t, h_loc, kv_loc, dh, dtype):
    """``[b, t, D]`` -> ``q [b, t, h_loc, dh]``, ``k, v [b, t, kv_loc,
    dh]`` (:220), from the fused MHA stack or the split GQA pair."""
    if "w_qkv" in params:
        w = params["w_qkv"][0, l]
        q, k, v = (torch.matmul(h, w[i]).to(dtype) for i in range(3))
    else:
        q = torch.matmul(h, params["w_q"][0, l]).to(dtype)
        k, v = (torch.matmul(h, params["w_kv"][0, l, i]).to(dtype) for i in range(2))
    return (
        q.reshape(b, t, h_loc, dh),
        k.reshape(b, t, kv_loc, dh),
        v.reshape(b, t, kv_loc, dh),
    )


def grouped_scores(q, ck_l, dh):
    """``q [b, 1, h, dh]`` grouped as ``[b, 1, h_kv, G, dh]`` against the
    kv-head cache -> ``[b, h_kv, G, 1, S]`` float32 (:248)."""
    b, t, h, _ = q.shape
    h_kv = ck_l.shape[2]
    q5 = q.float().reshape(b, t, h_kv, h // h_kv, dh) / float(np.sqrt(dh))
    return torch.einsum("bqhgd,bkhd->bhgqk", q5, ck_l.float())


def grouped_attend(p, cv_l, b, t, dtype):
    """``p [b, h_kv, G, 1, S]`` times the cache values -> ``[b, t, h*dh]``
    in query-head order ``hq = kvh * G + g`` (:258)."""
    attn = torch.einsum("bhgqk,bkhd->bqhgd", p, cv_l.float())
    return attn.reshape(b, t, -1).to(dtype)


def _scatter_drop(arr, index, dims, val, valid):
    """``arr[index] = val`` for the lanes where ``valid``; the others leave
    ``arr`` as it was (``mode='drop'``), without a host sync.

    ``index`` is a tuple of ``[b]`` index tensors into the leading
    ``len(index)`` dims of ``arr`` (sizes ``dims``). A dropped lane writes
    lane j's value to lane j's target, where j is the first kept lane, so
    no dropped lane can land on a kept lane's target with another value;
    with no kept lane, every lane writes back what its (clamped) target
    holds."""
    safe = tuple(ix.clamp(0, n - 1) for ix, n in zip(index, dims))
    j = torch.argmax(valid.int())
    keep = valid | ~valid.any()
    target = tuple(torch.where(keep, s, s[j]) for s in safe)
    wide = (slice(None),) + (None,) * (val.dim() - 1)
    cur = arr[target]
    src = torch.where(valid[wide], val, torch.where(keep[wide], cur, val[j]))
    arr[target] = src


def cache_write(cache: Cache, l: int, pos, k, v, int8: bool) -> Cache:
    """Store this step's ``k``/``v [b, t, h_kv, dh]`` at layer ``l``
    (quantizing first for an int8 cache), in place (:265).

    ``pos`` an int: rows ``[pos, pos + t)`` of every sequence (a prompt at
    0, or one token); past the cache it raises. ``pos`` a ``[b]`` tensor
    with ``t == 1``: sequence i's row at ``pos[i]``, dropped past the
    cache. Paged: ``t == 1`` through the table, dropped on the sentinel.
    """
    t = k.shape[1]
    paged = "table" in cache
    if paged and t != 1:
        raise ValueError(
            "a paged cache takes one-token writes; the t > 1 verify chunk is "
            "not yet ported to ddlb_tpu_torch"
        )
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if t != 1:
            raise ValueError("per-sequence positions take one-token writes")
        if paged:
            pages, rows = page_coords(cache, pos)
            index = (pages, rows)
            dims = cache["k"].shape[1:3]
            valid = pages < cache["k"].shape[1]
        else:
            index = (torch.arange(pos.shape[0], device=pos.device), pos.long())
            dims = cache["k"].shape[1:3]
            valid = (pos >= 0) & (pos < dims[1])
    else:
        if paged:
            raise ValueError("a paged cache takes per-sequence positions")
        pos = int(pos)
        if pos < 0 or pos + t > cache["k"].shape[2]:
            raise ValueError(
                f"rows [{pos}, {pos + t}) do not fit a cache of "
                f"{cache['k'].shape[2]} positions"
            )
        index = None

    def upd(name, val):
        if index is None:
            cache[name][l, :, pos:pos + t] = val
        else:
            _scatter_drop(cache[name][l], index, dims, val[:, 0], valid)

    if int8:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        upd("k", qk)
        upd("k_scale", sk)
        upd("v", qv)
        upd("v_scale", sv)
    else:
        upd("k", k)
        upd("v", v)
    return cache


def cache_read(cache: Cache, name: str, l: int, dtype) -> torch.Tensor:
    """Layer ``l`` as the linear ``[B, S_max, H_kv, dh]`` view (:337),
    dequantized through ``dtype`` for an int8 cache; a paged view gathers
    each slot's pages, zeros through the sentinel."""
    scale = cache.get(f"{name}_scale")
    if "table" in cache:
        table = cache["table"]
        b, mp = table.shape
        P, ps = cache[name].shape[1], cache[name].shape[2]
        mapped = ((table >= 0) & (table < P))[:, :, None, None, None]
        safe = table.long().clamp(0, P - 1)

        def lin(arr):
            pages = arr[l][safe]                    # [B, mp, ps, ...]
            pages = torch.where(mapped, pages, torch.zeros_like(pages))
            return pages.reshape((b, mp * ps) + tuple(arr.shape[3:]))

        view = lin(cache[name])
        if scale is None:
            return view
        return (view.float() * lin(scale)).to(dtype)
    arr = cache[name][l]
    if scale is None:
        return arr
    return (arr.float() * scale[l]).to(dtype)


def _live_mask(S_max, pos, window, device):
    iota = torch.arange(S_max, device=device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        live = iota[None, :] <= pos[:, None]            # [b, S]
        if window:
            live &= iota[None, :] > pos[:, None] - window
        return live[:, None, None, None, :]
    live = iota <= int(pos)
    if window:
        live &= iota > int(pos) - window
    return live[None, None, None, None]


def cache_attend(q, cache: Cache, l: int, dh: int, pos, dtype,
                 window: int = 0) -> torch.Tensor:
    """One query row per sequence against cache layer ``l`` (:376, t =
    1): grouped scores, the live mask at ``pos`` (an int or ``[b]``),
    softmax, value read -> ``[b, 1, h*dh]``."""
    b, t = q.shape[0], q.shape[1]
    if t != 1:
        raise ValueError(
            "cache attention over a t > 1 chunk is not yet ported to "
            "ddlb_tpu_torch"
        )
    s = grouped_scores(q, cache_read(cache, "k", l, dtype), dh)
    live = _live_mask(cache_max_len(cache), pos, window, s.device)
    p = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    return grouped_attend(p, cache_read(cache, "v", l, dtype), b, t, dtype)


def cache_attend_pallas(q, cache: Cache, l: int, pos, dtype,
                        cfg: TransformerConfig) -> torch.Tensor:
    """``q [b, 1, h, dh]`` against cache layer ``l`` through the fused
    kernels (:461): K12 for a paged cache, K11 otherwise."""
    b = q.shape[0]
    scales = {
        "k_scale": cache["k_scale"][l] if "k_scale" in cache else None,
        "v_scale": cache["v_scale"][l] if "v_scale" in cache else None,
    }
    q1 = q[:, 0].contiguous()
    if "table" in cache:
        out = da.paged_decode_attention(
            q1, cache["k"][l], cache["v"][l], cache["table"], pos,
            window=cfg.attn_window, **scales,
        )
    else:
        out = da.decode_attention(
            q1, cache["k"][l], cache["v"][l], pos, window=cfg.attn_window,
            **scales,
        )
    return out.reshape(b, 1, -1).to(dtype)


def routed_moe(h2d, params, cfg: TransformerConfig, l, B, dp, tp):
    """Balanced per-sequence routing on a full-width ``[B * per_seq, D]``
    slab (:413): block e of each dp shard's sequences through expert e.
    The oracle's formulation (all experts in ``params``)."""
    rows = h2d.shape[0]
    per_seq = rows // B
    b_dp = B // dp
    g = b_dp // tp
    u = torch.zeros_like(h2d)
    for i0 in range(0, B, b_dp):
        for e in range(tp):
            sl = slice((i0 + e * g) * per_seq, (i0 + (e + 1) * g) * per_seq)
            u[sl] = moe_ffn(
                h2d[sl], params["moe_w1"][0, l, e], params["moe_w2"][0, l, e],
                cfg.mlp_kernel, h2d.dtype, scales=ffn_scales(params, l, e, cfg),
            )
    return u


def block_moe(h2d, params, l, cfg: TransformerConfig, mesh):
    """This tp rank's block of whole sequences through its expert, then
    the tp all-gather of the rows (:439)."""
    rows = h2d.shape[0]
    g = rows // mesh.tp
    blk = h2d[mesh.tp_rank * g:(mesh.tp_rank + 1) * g]
    z = moe_ffn(
        blk, params["moe_w1"][0, l, 0], params["moe_w2"][0, l, 0],
        cfg.mlp_kernel, h2d.dtype, scales=ffn_scales(params, l, 0, cfg),
    )
    return mesh.tp_all_gather_rows(z)


def _out_proj(attn, params, l, x, mesh):
    """``x + psum_tp(attn @ w_o)``: the product rounded to the model dtype,
    summed over tp in float32, cast back."""
    part = torch.matmul(attn, params["w_o"][0, l])
    return x + mesh.axis_sum(part.float(), "tp").to(x.dtype)


def _logits(h, params):
    """The LM head as a float32 product (``preferred_element_type``)."""
    return torch.matmul(h.float(), params["head"].float())


def serving_body(params, cache, tokens, pos, cfg: TransformerConfig, mesh,
                 h_loc, kv_loc, dh):
    """The cached serving forward for ``tokens [b, 1]`` at ``pos`` (an int,
    or ``[b]``) (:505): ``(logits [b, 1, vocab] float32, cache)``."""
    b, t = tokens.shape
    if b % mesh.tp != 0:
        raise ValueError(f"per-dp batch {b} not divisible by tp={mesh.tp}")
    int8_cache = cfg.kv_cache == "int8"
    ragged = isinstance(pos, torch.Tensor) and pos.dim() == 1
    x = params["embed"][tokens.long()]
    if cfg.rope:
        posb = (
            pos[:, None] if ragged
            else (int(pos) + torch.arange(t, device=x.device))[None]
        )
    for l in range(cfg.layers_per_stage):
        h = rms_norm(x, params["ln1"][0, l])
        q, k, v = project_qkv(h, params, l, b, t, h_loc, kv_loc, dh, x.dtype)
        if cfg.rope:
            q = apply_rope(q, posb, cfg.rope_theta)
            k = apply_rope(k, posb, cfg.rope_theta)
        cache_write(cache, l, pos, k, v, int8_cache)
        if t == 1 and cfg.decode_kernel == "pallas":
            attn = cache_attend_pallas(q, cache, l, pos, x.dtype, cfg)
        else:
            attn = cache_attend(q, cache, l, dh, pos, x.dtype, window=cfg.attn_window)
        x = _out_proj(attn, params, l, x, mesh)
        h2 = rms_norm(x, params["ln2"][0, l])
        D = x.shape[-1]
        u = block_moe(h2.reshape(b * t, D), params, l, cfg, mesh)
        x = x + u.reshape(b, t, D)
    h = rms_norm(x, params["ln_f"])
    return _logits(h, params), cache


def _check_serving(cfg: TransformerConfig, mesh) -> None:
    if cfg.n_heads % mesh.tp != 0:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={mesh.tp}")
    if cfg.kv_heads % mesh.tp != 0:
        raise ValueError(f"n_kv_heads={cfg.kv_heads} not divisible by tp={mesh.tp}")


def make_decode_fn(mesh, cfg: TransformerConfig, ragged: bool = False):
    """One-token decode step on this rank (:568): ``decode_step(params,
    cache, tokens [B/dp], pos) -> (logits [B/dp, vocab] float32, cache)``,
    ``pos`` an int, or with ``ragged=True`` a ``[B/dp]`` int32 tensor of
    per-sequence positions."""
    _check_serving(cfg, mesh)
    if cfg.cache_layout == "paged" and mesh.dp != 1:
        raise ValueError(
            "cache_layout='paged' shares one page pool across the slot "
            "axis and requires dp=1 (run one engine per dp shard)"
        )
    h_loc, kv_loc, dh = cfg.n_heads // mesh.tp, cfg.kv_heads // mesh.tp, cfg.head_dim

    def decode_step(params, cache, tokens, pos):
        if ragged != (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            raise ValueError(
                "ragged=True takes a [B] position tensor; ragged=False one position"
            )
        logits, cache = serving_body(
            params, cache, tokens[:, None], pos, cfg, mesh, h_loc, kv_loc, dh
        )
        return logits[:, 0], cache

    return decode_step


def make_prefill_fn(mesh, cfg: TransformerConfig, dynamic_last: bool = False):
    """The prompt pass on this rank (:724): ``prefill(params, cache, tokens
    [B/dp, S]) -> (logits [B/dp, vocab] float32, cache)`` at position S-1,
    filling cache rows ``[0, S)``. ``dynamic_last=True`` takes a fourth
    argument ``last`` and reads that position's logits instead (a
    bucketed prompt padded past its length)."""
    _check_serving(cfg, mesh)
    if cfg.attn_kernel not in ("flash", "einsum"):
        raise ValueError(f"unknown attn_kernel '{cfg.attn_kernel}'")
    L = cfg.layers_per_stage
    h_loc, kv_loc, dh = cfg.n_heads // mesh.tp, cfg.kv_heads // mesh.tp, cfg.head_dim
    int8_cache = cfg.kv_cache == "int8"

    def body(params, cache, tokens, last):
        b, S = tokens.shape
        if b % mesh.tp != 0:
            raise ValueError(f"per-dp batch {b} not divisible by tp={mesh.tp}")
        x = params["embed"][tokens.long()]
        for l in range(L):
            h = rms_norm(x, params["ln1"][0, l])
            q, k, v = project_qkv(h, params, l, b, S, h_loc, kv_loc, dh, x.dtype)
            if cfg.rope:
                pos = torch.arange(S, device=x.device)[None]
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            cache_write(cache, l, 0, k, v, int8_cache)
            if int8_cache:
                # prompt attention reads the values later decode steps read
                k, v = kv_roundtrip(k), kv_roundtrip(v)
            if cfg.attn_kernel == "flash":
                attn = flash_full(q, k, v, window=cfg.attn_window)
            else:
                attn = causal_attention(q, k, v, window=cfg.attn_window)
            x = _out_proj(attn.reshape(b, S, h_loc * dh), params, l, x, mesh)
            h2 = rms_norm(x, params["ln2"][0, l])
            D = x.shape[-1]
            u = block_moe(h2.reshape(b * S, D), params, l, cfg, mesh)
            x = x + u.reshape(b, S, D)
            del q, k, v, attn, h, h2, u
        # K/V row j and hidden row i depend only on tokens <= themselves,
        # so a bucket's pad tail never reaches rows [0, last]
        h_last = rms_norm(x[:, -1 if last is None else int(last)], params["ln_f"])
        return _logits(h_last, params), cache

    if dynamic_last:
        def prefill(params, cache, tokens, last):
            return body(params, cache, tokens, last)
    else:
        def prefill(params, cache, tokens):
            return body(params, cache, tokens, None)
    return prefill


def make_generate_fn(mesh, cfg: TransformerConfig, n_new: int):
    """Greedy generation (:949, ``temperature=0``): ``generate(params,
    cache, prompt [B/dp, S0]) -> tokens [B/dp, S0 + n_new]`` int32 --
    prefill, ``n_new - 1`` decode steps, the last token from the carried
    logits. The cache must hold ``S0 + n_new`` positions."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    decode = make_decode_fn(mesh, cfg)
    prefill = make_prefill_fn(mesh, cfg)

    def generate(params, cache, prompt):
        B, S0 = prompt.shape
        S_max = cache_max_len(cache)
        if S0 + n_new > S_max:
            raise ValueError(
                f"cache holds {S_max} positions < prompt {S0} + n_new {n_new}"
            )
        logits, cache = prefill(params, cache, prompt)
        tokens = torch.zeros((B, S0 + n_new), dtype=torch.int32, device=prompt.device)
        tokens[:, :S0] = prompt
        for i in range(n_new - 1):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens[:, S0 + i] = nxt
            logits, cache = decode(params, cache, nxt, S0 + i)
        tokens[:, S0 + n_new - 1] = torch.argmax(logits, dim=-1).to(torch.int32)
        return tokens

    return generate


#: the oracle's score blocks stay near this many bytes (query chunking)
ORACLE_CHUNK_BYTES = 1 << 30


def oracle_attention(q, k, v, window: int = 0) -> torch.Tensor:
    """Exact causal attention without the ``[B, H, S, S]`` scores (:1262):
    query rows in chunks of ``[B, H, chunk, S]`` float32 near 1 GiB, each
    softmaxed over the full key range, in float32 from the model-dtype
    operands (the JAX oracle's bf16 products summed in f32)."""
    B, S, H, dh = q.shape
    if k.shape[2] != H:
        G = H // k.shape[2]
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    kh = k.float().permute(0, 2, 1, 3).contiguous()       # [B, H, S, dh]
    vh = v.float().permute(0, 2, 1, 3).contiguous()
    chunk = S
    while B * H * chunk * S * 4 > ORACLE_CHUNK_BYTES and chunk > 1:
        chunk = (chunk + 1) // 2
    scale = 1.0 / float(np.sqrt(dh))
    cols = torch.arange(S, device=q.device)[None, :]
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk):
        qc = q[:, q0:q0 + chunk].float().permute(0, 2, 1, 3)
        s = torch.matmul(qc, kh.transpose(-1, -2)) * scale
        rows = q0 + torch.arange(qc.shape[2], device=q.device)[:, None]
        mask = rows >= cols
        if window:
            mask &= cols > rows - window
        s.masked_fill_(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        out[:, q0:q0 + chunk] = torch.matmul(p, vh).permute(0, 2, 1, 3).to(q.dtype)
    return out


def reference_logits(params, tokens, cfg: TransformerConfig, tp: int,
                     dp: int) -> torch.Tensor:
    """Single-device oracle (:1294): the teacher-forced full forward over
    ``tokens [B, S]`` with the full parameters (every head and expert),
    logits at the last position ``[B, vocab]`` float32. Sequence i of a
    dp shard uses expert ``i // (B / (dp * tp))``, as the cache path."""
    B, S = tokens.shape
    D = cfg.d_model
    x = params["embed"][tokens.long()]
    for l in range(cfg.layers_per_stage):
        h = rms_norm(x, params["ln1"][0, l])
        q, k, v = project_qkv(
            h, params, l, B, S, cfg.n_heads, cfg.kv_heads, cfg.head_dim, x.dtype
        )
        if cfg.rope:
            pos = torch.arange(S, device=x.device)[None]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cfg.kv_cache == "int8":
            k, v = kv_roundtrip(k), kv_roundtrip(v)
        attn = oracle_attention(q, k, v, window=cfg.attn_window).reshape(B, S, D)
        x = x + torch.matmul(attn, params["w_o"][0, l]).to(x.dtype)
        h2 = rms_norm(x, params["ln2"][0, l])
        u = routed_moe(h2.reshape(B * S, D), params, cfg, l, B, dp, tp)
        x = x + u.reshape(B, S, D)
        del q, k, v, attn, h, h2, u
    return _logits(rms_norm(x[:, -1], params["ln_f"]), params)

