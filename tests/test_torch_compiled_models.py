"""The ``compiled`` members' int8 rows (K7 through its operators) against
the ``spmd`` member, and the learned routers through the compiled step
against the JAX ``xla_gspmd`` member, at world 1 on the CPU. Split from
``test_torch_compiled.py``, whose twins and tolerances they use, so that
the test runner's workers can share the compiled tests (a file is one
unit of work).
"""

import numpy as np
import pytest

from test_torch_compiled import (
    DECODE,
    DECODE_SHAPE,
    LR,
    STEP,
    STEP_SHAPE,
    adam_atol,
    jax_devices,
    load_jax,
    load_port,
)

#: the int8 MLP rows of the compiled members, K7 through its operators
INT8_ROWS = [("transformer_step", "train", "int8"),
             ("transformer_step", "forward", "int8_weights"),
             ("transformer_decode", "decode", "int8"),
             ("transformer_decode", "decode", "int8_weights")]


@pytest.mark.parametrize("family,mode,mlp_kernel", INT8_ROWS, ids=str)
def test_int8_rows_match_spmd_at_world_one(family, mode, mlp_kernel):
    """The compiled int8 rows (the int8 GEMMs as ``ddlb::int8_matmul`` and
    ``ddlb::int8_ste_matmul`` nodes of the graph) against the ``spmd``
    member's eager rows with einsum attention: the loss or logits within
    1e-4 (a float32 difference in the fused graph can move one value
    across a quantization step, as in ``test_torch_transformer_step.py``),
    the train step's parameters under ``adam_atol``, each row valid."""
    if family == "transformer_step":
        opts = dict(STEP, mode=mode, mlp_kernel=mlp_kernel, dp=1, tp=1, pp=1)
        shape = STEP_SHAPE
    else:
        opts = dict(DECODE, phase=mode, mlp_kernel=mlp_kernel, dp=1, tp=1)
        shape = DECODE_SHAPE
    rows = {}
    for member, extra in (("compiled", {}), ("spmd", {"attn_kernel": "einsum"})):
        impl = load_port(family, member)(*shape, dtype="float32", device="cpu", **opts, **extra)
        out = impl.run()
        assert impl.validate(out), member
        rows[member] = (impl, out)
    (impl, got), (_, want) = rows["compiled"], rows["spmd"]
    if family == "transformer_decode":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
        return
    if mode == "forward":
        assert float(got) == pytest.approx(float(want), abs=1e-4)
        return
    assert float(got[-1]) == pytest.approx(float(want[-1]), abs=1e-4)
    for name, new in want[0].items():
        init = impl._args[0][name].to_local().numpy()
        err = np.abs(got[0][name].numpy() - new.numpy())
        assert np.all(err <= adam_atol(init, new.numpy()) + 2 * LR * (init != init)), name


@pytest.mark.parametrize("router,mode", [("topk", "forward"), ("expert_choice", "train")])
def test_routers_match_jax_at_world_one(router, mode):
    """The learned routers through the compiled step (one expert at world
    1) against the JAX ``xla_gspmd`` member."""
    opts = dict(router=router, router_topk=1, capacity_factor=0.5)
    impl = load_port("transformer_step", "compiled")(
        *STEP_SHAPE, dtype="float32", device="cpu", mode=mode, dp=1, tp=1, pp=1, **STEP,
        **opts)
    out = impl.run()
    assert impl.validate(out)
    with jax_devices(1):
        ref = load_jax("transformer_step", "xla_gspmd")(
            *STEP_SHAPE, dtype="float32", mode=mode, dp=1, tp=1, pp=1, **STEP, **opts)
        want = ref.run()
    loss = out if mode == "forward" else out[-1]
    want_loss = want if mode == "forward" else want[-1]
    assert float(loss) == pytest.approx(float(want_loss), abs=1e-4)
