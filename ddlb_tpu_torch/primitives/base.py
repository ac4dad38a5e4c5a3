"""Primitive contract: seeded operands, sharding by rank, validation.

The PyTorch counterpart of the JAX package's ``primitives/base.py``. The
contract is the same -- ``__init__(m, n, k, dtype, seed, **options)`` /
``run()`` / ``validate(result)`` / ``get_inputs()`` / ``flops()`` with
class-level ``DEFAULT_OPTIONS`` / ``ALLOWED_VALUES`` -- but each rank holds
its own operand shards as plain tensors on its own device, and the
collectives are ``torch.distributed`` calls (``runtime.py``). Operands come
from the same numpy seed code as the JAX package, so both build
bit-identical inputs.

A family whose schema carries ``transport`` (``ici|dcn``) has its ring laid
out for it (``Runtime.order_ring``, the JAX package's
``Runtime.transport_mesh``), and ``self.rank`` is this rank's ring
position: the rank at position ``p`` holds row block ``p``, as the JAX
device at mesh position ``p`` does. The ring members walk that order
(``ring_shift``, the kernels' peer tables); a member that makes one NCCL
or gloo call gets rank-ordered blocks back, which the runtime permutes
into position order. So a ``dcn`` row of an NCCL member runs the same
NCCL call as its ``ici`` row, in rank order on NCCL's own route, plus that
permutation; under ``ici``, and on one node, the order is the identity
and nothing is permuted.
"""

from __future__ import annotations

import contextlib
import logging
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ddlb_tpu_torch.ops.accum import torch_matmul  # noqa: F401  (the members' GEMM)
from ddlb_tpu_torch.options import OptionsManager
from ddlb_tpu_torch.perfmodel.cost import estimate
from ddlb_tpu_torch.runtime import Runtime

log = logging.getLogger(__name__)

DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
}
DTYPE_NAMES = tuple(DTYPES)


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"Unsupported dtype '{name}'. Supported: {DTYPE_NAMES}")
    return DTYPES[name]


#: operand dtypes whose GEMMs must run in true float32/float64
_HIGH_PRECISION_DTYPES = ("float32", "float64")


@contextlib.contextmanager
def matmul_precision_scope(dtype_name: str):
    """TF32 off for a float32/float64 row, restored on exit.

    TF32 keeps about three decimal digits, which breaks the f32 validation
    contract (``atol = 1e-4 * k``). PyTorch's matmul default is already
    full f32, but cuDNN's is TF32 and a user may have turned either on, so
    f32/f64 rows set both ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False for the call. Half and
    integer rows are left as they are.
    """
    if dtype_name not in _HIGH_PRECISION_DTYPES:
        yield
        return
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        ) = saved


def with_matmul_precision(fn, dtype_name: str):
    """Wrap ``fn`` so every call runs under ``matmul_precision_scope``."""
    if dtype_name not in _HIGH_PRECISION_DTYPES:
        return fn

    def wrapped(*args, **kwargs):
        with matmul_precision_scope(dtype_name):
            return fn(*args, **kwargs)

    return wrapped


def validation_atol(dtype: str, k: int) -> float:
    """Reference tolerance rule: rtol=0, atol=(1e-3 half / 1e-4 else)*k."""
    base = 1e-3 if dtype in ("float16", "bfloat16") else 1e-4
    return base * k


def _tensor_from_numpy(x: np.ndarray) -> torch.Tensor:
    # a copy: the tensor then owns its memory, even when ``x`` is a
    # read-only array from JAX or a view that would pin a larger buffer
    x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (what a JAX bf16 array becomes on the host)
        # has no torch counterpart in from_numpy: move the bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def place(x: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    """Host array -> operand tensor on ``device`` in the named dtype.

    The conversion the JAX package applies in ``Primitive._device_put``:
    the host array (float32, float64 or integer) is moved as it is, then
    cast, which rounds float32 to bfloat16/float16 to nearest even.
    """
    return _tensor_from_numpy(x).to(device).to(torch_dtype(dtype))


def operands_from_numpy(
    a: np.ndarray, b: np.ndarray, dtype: str, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place two host arrays (for example a JAX primitive's
    ``get_inputs()`` pulled to the host) as this package's operands."""
    device = torch.device(device)
    return place(a, dtype, device), place(b, dtype, device)


#: the one seeded operand draw kept per process (``seeded_draw``)
_DRAW_MEMO: Dict[tuple, Tuple[np.ndarray, ...]] = {}


def seeded_draw(key: tuple, draw) -> Tuple[np.ndarray, ...]:
    """Copies of ``draw()``'s arrays, drawn once for ``key``: every row of a
    sweep at one shape draws the same seeded operands, and at 8192^2 the
    draw takes seconds where a copy takes a tenth of one. One entry is kept
    per process."""
    if key not in _DRAW_MEMO:
        _DRAW_MEMO.clear()
        _DRAW_MEMO[key] = tuple(draw())
    return tuple(x.copy() for x in _DRAW_MEMO[key])


#: the one reference product kept per process, keyed by (seed, m, n, k,
#: dtype): a host float32 GEMM costs about 1.1 TFLOP at 8192^3, and every
#: validated row of a sweep at one shape asks for the same product
_EXPECTED_MEMO: Dict[tuple, np.ndarray] = {}


class Primitive(ABC):
    """Base for all benchmarkable primitives."""

    primitive_name = ""

    #: how the cost model (``perfmodel.cost``) combines this member's
    #: terms: "sequential" (collective and GEMM back to back, the
    #: default), "overlap" (pipelined: the max() bound; the overlap, cuda,
    #: ring and pipeline members), "compute_only" (no collective runs: the
    #: comm term is dropped)
    COST_SCHEDULE: str = "sequential"

    #: dtype whose peak prices the compute term; None = the operand dtype.
    #: The quantized members set "int8": their GEMMs run at the int8 rate,
    #: and pricing them at the operand's would fake a perfect
    #: roofline_frac
    COST_DTYPE: Optional[str] = None

    #: option schema read by the options manager
    DEFAULT_OPTIONS: Dict[str, Any] = {}
    ALLOWED_VALUES: Dict[str, Any] = {}
    #: family-level schema layered under the member's (axes every member
    #: of a family shares, declared once on the family base)
    BASE_OPTIONS: Dict[str, Any] = {}
    BASE_ALLOWED: Dict[str, Any] = {}

    @classmethod
    def option_schema(cls) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(defaults, allowed) with the family-level entries merged in."""
        return (
            {**cls.BASE_OPTIONS, **cls.DEFAULT_OPTIONS},
            {**cls.BASE_ALLOWED, **cls.ALLOWED_VALUES},
        )

    def __init__(
        self,
        m: int,
        n: int,
        k: int,
        dtype: str = "bfloat16",
        seed: int = 42,
        device: str = "cuda",
        **options: Any,
    ) -> None:
        self.m, self.n, self.k = int(m), int(n), int(k)
        torch_dtype(dtype)  # an unknown dtype fails before any device work
        self.dtype = dtype
        self.seed = int(seed)
        self.runtime = Runtime(device)
        self.device = self.runtime.device
        self.num_partitions = self.runtime.world_size
        self._options_manager = OptionsManager(*self.option_schema())
        self.options = self._options_manager.parse(options)
        if "transport" in self.options:
            # the family carries the ici/dcn axis: lay the ring out for it
            # (the JAX package's ``Runtime.transport_mesh``)
            self.runtime.order_ring(self.options["transport"])
        #: this rank's ring position: the row block of a global array it holds
        self.rank = self.runtime.position
        self._check_shapes()
        self._input_setup()
        # the f32/f64 accuracy contract covers whatever step the member built
        self._fn = with_matmul_precision(self._fn, self.dtype)

    # -- hooks ---------------------------------------------------------------

    def _check_shapes(self) -> None:
        """Shape-divisibility constraints; overridden per primitive."""

    @abstractmethod
    def _input_setup(self) -> None:
        """Place this rank's operands (those ``_call_args`` names) and set
        the step ``self._fn``."""

    @property
    def _call_args(self) -> Tuple[torch.Tensor, ...]:
        """Operand tuple for ``self._fn`` (override for other arities)."""
        return (self.a, self.b)

    def run(self) -> torch.Tensor:
        """Execute one iteration; returns this rank's result tensor."""
        return self._fn(*self._call_args)

    def flops(self) -> float:
        """FLOP count of one iteration (2*m*n*k, for throughput)."""
        return 2.0 * self.m * self.n * self.k

    # -- cost model ----------------------------------------------------------

    def cost_dtype(self) -> str:
        """The dtype whose peak prices this member's compute term."""
        return self.COST_DTYPE or self.dtype

    def overlap_chunks(self) -> Optional[int]:
        """Pipeline depth of an "overlap" member whose interleave has a
        known finite granularity (the chunked engine's ``chunk_count``,
        under ``algorithm="chunked"``): the cost model then charges the
        fill and drain, ``min(compute, comm) / chunks``, on top of the
        ideal ``max()``. None for every other member and algorithm."""
        if self.options.get("algorithm") == "chunked":
            return int(self.options["chunk_count"])
        return None

    def cost_model(self):
        """This member's cost-model verdict against its runtime's chip
        (``perfmodel.cost.CostEstimate``): the family's model combined by
        ``COST_SCHEDULE``. The runner stamps every row's ``predicted_s``,
        ``roofline_frac``, ``bound`` and ``chip`` from it; members override
        its inputs (``flops``, ``wire_bytes``, ``hbm_bytes``,
        ``COST_SCHEDULE``) rather than the hook."""
        return estimate(self)

    @abstractmethod
    def validate(self, result: torch.Tensor) -> bool:
        """Compare against the single-device reference product."""

    def extra_row_fields(self) -> Dict[str, Any]:
        """Family-specific measured columns added to the result row after
        validation (none by default)."""
        return {}

    def get_inputs(self) -> Tuple[torch.Tensor, ...]:
        """This rank's operand tensors."""
        return self._call_args

    # -- operand construction ------------------------------------------------

    def _host_operands(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded uniform [-1, 1] operands, built identically on every rank
        and by the JAX package (the same code, the same seed); copies of
        the draw ``seeded_draw`` keeps."""
        def draw():
            rng = np.random.default_rng(self.seed)
            gen_dtype = np.float64 if self.dtype == "float64" else np.float32
            a = (rng.uniform(-1.0, 1.0, (self.m, self.k))).astype(gen_dtype)
            b = (rng.uniform(-1.0, 1.0, (self.k, self.n))).astype(gen_dtype)
            if self.dtype in ("int32", "int64"):
                # Small integers keep the product exactly representable.
                a = np.rint(a * 3).astype(self.dtype)
                b = np.rint(b * 3).astype(self.dtype)
            return a, b

        return seeded_draw(("operands", self.seed, self.m, self.n, self.k, self.dtype), draw)

    def _place(self, host: np.ndarray) -> torch.Tensor:
        return place(host, self.dtype, self.device)

    # -- validation ----------------------------------------------------------

    def _expected_full(self) -> np.ndarray:
        """Single-device reference product in float32/float64 accumulation,
        on the host; memoised (one entry per process)."""
        key = (self.seed, self.m, self.n, self.k, self.dtype)
        if key not in _EXPECTED_MEMO:
            _EXPECTED_MEMO.clear()
            a, b = self._host_operands()
            acc = np.float64 if self.dtype == "float64" else np.float32
            _EXPECTED_MEMO[key] = a.astype(acc) @ b.astype(acc)
        return _EXPECTED_MEMO[key]

    def _compare(
        self, result: torch.Tensor, want: np.ndarray, atol: Optional[float] = None
    ) -> bool:
        """``result`` against ``want`` at rtol=0 and ``atol``: by default
        the reference rule (``validation_atol``); the quantized members
        pass ``quantization_atol(k)``."""
        host_dtype = torch.float64 if want.dtype == np.float64 else torch.float32
        got = result.detach().to("cpu", host_dtype).numpy()
        if atol is None:
            atol = validation_atol(self.dtype, self.k)
        if got.shape == want.shape and np.allclose(got, want, rtol=0.0, atol=atol):
            return True
        err = (
            float(np.max(np.abs(got - want)))
            if got.shape == want.shape and got.size
            else float("nan")
        )
        log.warning(
            "validation FAILED for %s rank %d: shape %s vs %s, "
            "max|err|=%.3e > atol=%.3e",
            type(self).__name__, self.rank, got.shape, want.shape, err, atol,
        )
        return False

    def _compare_rows(
        self, result: torch.Tensor, expected: np.ndarray,
        atol: Optional[float] = None,
    ) -> bool:
        """A sequence-sharded result (this rank's ``m/d`` rows) against its
        row block of the full oracle ``expected``: the per-rank counterpart
        of the JAX package's ``_compare_global``."""
        rows = expected.shape[0] // self.num_partitions
        return self._compare(
            result, expected[self.rank * rows:(self.rank + 1) * rows], atol
        )

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(m={self.m}, n={self.n}, k={self.k}, "
            f"dtype={self.dtype}, partitions={self.num_partitions}, "
            f"device={self.device})"
        )


class ComputeOnlyKSharded:
    """Compute-only roofline shared by the k-contracted families
    (``tp_rowwise``, ``dp_allreduce``; ``ep_alltoall`` keeps the size
    schema and validation with its own operands): ``sharded`` times one
    rank's partial GEMM
    ``[m, k/d] @ [k/d, n]`` (validation skipped: partial sums are not the
    answer), ``unsharded`` the full product on one device. Mixin, combined
    with the family base."""

    #: no collective runs: the cost model drops the comm term
    COST_SCHEDULE = "compute_only"

    DEFAULT_OPTIONS = {"size": "sharded"}
    ALLOWED_VALUES = {"size": ["sharded", "unsharded"]}

    def wire_bytes(self) -> float:
        """No collective runs: nothing on the wire."""
        return 0.0

    def _input_setup(self) -> None:
        a_host, b_host = self._host_operands()
        if self.options["size"] == "sharded":
            kd = self.k // self.num_partitions
            a_host = a_host[:, :kd]
            b_host = b_host[:kd]
        self.a = self._place(a_host)
        self.b = self._place(b_host)
        self._fn = torch_matmul

    def validate(self, result: torch.Tensor) -> bool:
        if self.options["size"] == "sharded":
            return True
        return self._compare(result, self._expected_full())
