"""Time the rectangle's and the chunk fold's flash kernel beside SDPA on one card.

    python scripts/time_flash_band.py [--tree DIR] [--label NAME]

The port's wrappers send K8b (the rectangle: a row offset, a window, GQA)
and K9 (the carried chunk fold) in bf16/fp16 to ``ddlb_flash_forward_band``
and ``ddlb_flash_chunk_band`` (``band::flash_fwd_wgmma``). This script
calls them on bf16 inputs at the main paths' shapes:

- K9: the diagonal chunk of the attention path (16384², 8 heads) and of
  the training step's ring rows (2048², the step's 32 and 16 merged
  heads), and a ``past`` chunk of 4096² at offsets 12288/8192 with GQA
  8/2, each folded again and again into one carry in place;
- K8b: its row's shape (4096 rows at offset 12288 of 16384 keys, window
  4096, GQA 8/2), the world-1 windowed path (16384² at offset 0, window
  4096, GQA 8/2) and the training row (4096², 64 merged heads, window
  1024).

Beside them, on the same timer, SDPA (``scaled_dot_product_attention``):
``is_causal`` for a diagonal chunk, no mask for the past chunk (its kv
heads repeated to the query heads), and for K8b the band as a boolean mask
over the keys the band can reach. SDPA computes the normalised attention,
not a fold into an unnormalised carry: it is a yardstick of the same work,
not the same function. Each pair runs in ``time_flash_triangle``'s four
turns that alternate the order; it prints CUDA-event milliseconds per
launch, the bound (``chip_smoke.flash_bound``) and the card's name and
power limit, one JSON line a shape. It checks nothing; ``chip_smoke.py``
and the card tests hold the kernels against their plain versions. To
compare with an older generation, run it again with ``--tree`` at a
checkout of that commit (unpacked with ``git archive`` into a directory
``.gitignore`` lists), in turns, one process a tree: a checkout without
the band kernel's entry points runs both cases in bf16 through
``ddlb_flash_forward`` and ``ddlb_flash_chunk``, on the ``mma.sync``
forward (``flash_mma``) that the band kernel replaced.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from time_flash_triangle import time_turns  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: K9: (name, sequence of q and k, query heads, kv heads, row offset, col
#: offset, mode: 1 = diagonal, 2 = past)
CHUNK_SHAPES = (
    ("diagonal, attention path", 16384, 8, 8, 0, 0, 1),
    ("diagonal, training ring (mb 2)", 2048, 32, 32, 0, 0, 1),
    ("diagonal, training ring (mb 4)", 2048, 16, 16, 0, 0, 1),
    ("past, GQA 8/2", 4096, 8, 2, 12288, 8192, 2),
)
#: K8b: (name, query rows, keys, query heads, kv heads, row offset, window)
RECT_SHAPES = (
    ("K8b row: 4096 at 12288 of 16384", 4096, 16384, 8, 2, 12288, 4096),
    ("world-1 windowed path", 16384, 16384, 8, 2, 0, 4096),
    ("training row, window 1024", 4096, 4096, 64, 64, 0, 1024),
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT, help="root of the checkout whose kernels to time")
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is false")
    import ddlb_tpu_torch
    from chip_smoke import flash_bound
    from ddlb_tpu_torch.ops import flash_attention as fa

    if not os.path.abspath(ddlb_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {ddlb_tpu_torch.__file__}, not the checkout at {tree}")
    lib = fa._lib()
    # the tree's bf16 entry points: the band kernel's, or (older trees) flash_mma's
    band = hasattr(lib, "ddlb_flash_chunk_band")
    kernel = "band" if band else "flash_mma"
    chunk_entry = lib.ddlb_flash_chunk_band if band else lib.ddlb_flash_chunk
    forward_entry = lib.ddlb_flash_forward_band if band else lib.ddlb_flash_forward
    label = args.label or tree
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    scale = 128 ** -0.5

    def draw(s, h):
        return (torch.rand((s, h, 128), generator=gen, device="cuda") * 2 - 1).bfloat16()

    def heads_first(x, group=1):
        x = x.transpose(0, 1)
        return (x.repeat_interleave(group, 0) if group > 1 else x).contiguous()[None]

    for name, s, h, h_kv, row, col, mode in CHUNK_SHAPES:
        q, k, v = draw(s, h), draw(s, h_kv), draw(s, h_kv)
        acc, m, l = fa.init_flash_carry(s, h, 128, "cuda")
        args = (2, q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), s, s, h, h_kv, 128, scale, row, col, mode, 0, stream)
        qt, kt, vt = heads_first(q), heads_first(k, h // h_kv), heads_first(v, h // h_kv)
        times = time_turns({
            kernel: lambda: chunk_entry(*args),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=mode == 1,
                                                           scale=scale),
        })
        # diagonal: the triangle in relative positions; past: every pair
        bound = flash_bound(fa, s, s, h, h_kv, 128, 2, 0, 0, mode == 1, 0, carry=True)
        print(json.dumps({"label": label, "kernel": "K9", "shape": name, "s": s, "heads": [h, h_kv],
                          "offsets": [row, col], "mode": fa.CHUNK_MODES[mode], "card": card,
                          "bound_ms": bound[0], "bound_by": bound[1], "ms": times}))
        del q, k, v, acc, m, l, qt, kt, vt
    for name, sq, skv, h, h_kv, row, window in RECT_SHAPES:
        q, k, v = draw(sq, h), draw(skv, h_kv), draw(skv, h_kv)
        o = torch.empty_like(q)
        lse = torch.empty((h, sq, 1), device="cuda")
        args = (2, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                sq, skv, h, h_kv, 128, scale, row, 1, window, stream)
        # SDPA over the keys the band can reach, with the band as a mask
        lo = max(row - window + 1, 0)
        qt = heads_first(q)
        kt, vt = heads_first(k[lo:], h // h_kv), heads_first(v[lo:], h // h_kv)
        pos_q = row + torch.arange(sq, device="cuda")[:, None]
        pos_k = lo + torch.arange(skv - lo, device="cuda")[None, :]
        band = (pos_k <= pos_q) & (pos_k > pos_q - window)
        times = time_turns({
            kernel: lambda: forward_entry(*args),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                           scale=scale),
        })
        bound = flash_bound(fa, sq, skv, h, h_kv, 128, 2, row, 0, True, window, carry=False)
        print(json.dumps({"label": label, "kernel": "K8b", "shape": name, "sq": sq, "skv": skv,
                          "heads": [h, h_kv], "row_offset": row, "window": window,
                          "card": card, "bound_ms": bound[0], "bound_by": bound[1],
                          "ms": times}))
        del q, k, v, o, lse, qt, kt, vt, band


if __name__ == "__main__":
    main()
