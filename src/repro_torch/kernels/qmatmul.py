"""int8 x int8 -> int32 quantized matmul with the fused epilogue.

Port of ``repro.kernels.qmatmul`` (TPU: ``qmatmul_pallas``).  The Hopper
kernel is ``csrc/qmatmul.cu``; its plain version is
:func:`repro_torch.kernels.ref.qmatmul_ref`, re-exported here as
:func:`qmatmul_plain`.

:func:`qmatmul` is the kernel's wrapper: for CPU tensors it runs the
plain version (that is how the CPU tests reach it), for CUDA tensors it
launches the kernel or raises -- it never falls back.  The kernel has
three instances (the TMA weight stream at M <= 64, TMA and int8 wgmma
above it, with a narrow tile where N and K are at most 64, the parent
cp.async kernel as the control for what TMA cannot address);
:func:`qmatmul_plan` picks one, its tiles, split and ring from the shape
and the SM count.

Training under ``--quant int8`` differentiates it through
:class:`QmatmulFn`: the int8 payloads are constants, so the gradients
are those of ``a_scale``, ``b_scale`` and ``bias``
(:func:`qmatmul_bwd`: the ``qmatmul_bwd`` kernel, ``csrc/qmatmul_bwd.cu``,
which recomputes the int32 products and reduces ``dout`` through the
epilogue's derivative; plain version :func:`~repro_torch.kernels.ref.
qmatmul_bwd_plain`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.tables import INDEXING, TableSpec, get_table
from . import _cuda
from .ref import qmatmul_bwd_plain
from .ref import qmatmul_ref as qmatmul_plain

__all__ = ["qmatmul", "qmatmul_plain", "qmatmul_plan", "QmmPlan",
           "qmatmul_bwd", "QmatmulFn", "MAX_TABLE"]

#: longest activation table the kernel keeps in shared memory
MAX_TABLE = 8192
#: weight columns of a TMA box (one consumer warpgroup's), K bytes of a
#: stage of the TMA instances
BOX, BK = 128, 128
#: the narrow wgmma tile: its weight columns, the most K it takes (one
#: stage, in k32 steps)
NARROW = 64
#: the token rows a weight-stream block can take, the wgmma one's and the
#: narrow tile's
STREAM_ROWS = (8, 16, 32, 64)
WGMMA_ROWS = (64, 128)
NARROW_ROWS = (32, 64)
#: a K of at most this many bytes (4 stages) at M <= 16 runs the control:
#: the TMA ring has nothing to overlap there (measured: PERF.md section 6)
SHORT_K = 512
#: shared memory a ring may fill: one block an SM, or two
_RING_ONE, _RING_TWO = 200 * 1024, 108 * 1024


@dataclass(frozen=True)
class QmmPlan:
    """How one call is cut into blocks (:func:`qmatmul_plan`).

    ``instance``: "stream" (the TMA weight stream, mma.sync, M <= 64),
    "wgmma" (TMA and int8 wgmma, M > 64; the narrow tile where ``cols``
    is :data:`NARROW`) or "control" (the parent ``mma.sync`` kernel, for
    what TMA cannot address).  A block owns ``cols`` weight columns by
    ``rows`` tokens and one of ``splits`` contiguous ranges of the
    ``bk``-byte K stages, on a ring of ``stages`` stages; a split tile's
    blocks add exact int32 partial sums into the workspace and its last
    block (one ticket a tile) applies the epilogue.
    """
    instance: str
    m: int
    n: int
    k: int
    cols: int
    rows: int
    bk: int
    splits: int
    stages: int

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.cols)

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.rows)

    @property
    def tiles(self) -> int:
        return self.n_tiles * self.m_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def k_stages(self) -> int:
        return -(-self.k // self.bk)

    def split_range(self, z: int):
        """K bytes [k0, k1) of split ``z`` (the kernels' formulas: the
        TMA instances cut the stages evenly, the control in ceil-sized
        runs, whose last may be short or empty)."""
        kst = self.k_stages
        if self.instance == "control":
            per = -(-kst // self.splits)
            s0, s1 = min(kst, z * per), min(kst, (z + 1) * per)
        else:
            s0, s1 = z * kst // self.splits, (z + 1) * kst // self.splits
        return min(self.k, s0 * self.bk), min(self.k, s1 * self.bk)


def tma_addressable(n: int, k: int) -> bool:
    """TMA's rule on the operands' rows: 16-byte multiples."""
    return n % 16 == 0 and k % 16 == 0


def _control_plan(m: int, n: int, k: int, sms: int) -> QmmPlan:
    """The parent kernel's tiling and split (measured on the H100 in PR
    15-16, PERF.md section 6).  Decode (M <= 16): ~1 block per SM when
    fewer tiles than half the SMs exist, down to one K stage per block;
    a K of <= 4 stages is not split.  M > 16 (128 x 128 tiles, whose 16K
    int32 atomics per block cost more than a short K saves): only a long
    K (>= 128 stages) on fewer tiles than half the SMs, ~1 block per SM
    with >= 32 stages each."""
    tiles = -(-n // 128)
    if m <= 16:
        kst = -(-k // 128)
        splits = (1 if 2 * tiles >= sms or kst <= 4
                  else max(1, min(-(-sms // tiles), kst)))
        return QmmPlan("control", m, n, k, 128, 16, 128, splits, 6)
    tiles *= -(-m // 128)
    kst = -(-k // 64)
    splits = (1 if 2 * tiles >= sms or kst < 128
              else max(1, min(-(-sms // tiles), kst // 32)))
    return QmmPlan("control", m, n, k, 128, 128, 64, splits, 4)


def qmatmul_plan(m: int, n: int, k: int, sms: int,
                 instance: Optional[str] = None) -> QmmPlan:
    """The launch for an (M, K) x (K, N) call on a card of ``sms`` SMs:
    plain Python of the shape (and the SM count), as the CPU tests hold
    it.  ``instance`` forces one (the card's checks run the control
    beside the planned instance).

    * K or N not a multiple of 16 (TMA cannot address the rows), or M
      <= 16 with a K of at most 4 stages (a ring with nothing to
      overlap, measured no faster): the control, the parent kernel with
      its own split;
    * M <= 64, the weight stream: the fewest token rows that hold M;
      blocks of one 128-column box (two or four, longer runs of each
      weight row, measured no faster: PERF.md section 6); split over K
      until the tiles fill the SMs, while the splits' int32 atomics (M N
      a split) stay under a sixteenth of the weight bytes;
    * M > 64 with N and K at most 64 (the jet's layers), the narrow wgmma
      tile: 64 weight columns, the K in one stage, 32 token rows while
      that grid has at most one block an SM, else 64 (measured: PERF.md
      section 6);
    * M > 64, wgmma: 128 token rows, or 64 (with the same boxes) where
      that grid fits one wave of blocks; two boxes a block unless N has
      only one or that leaves more than half the SMs idle; split under
      the same atomics rule only when the tiles leave half the SMs idle.

    The ring holds as many stages as a block runs, up to the shared
    memory of one block an SM (two, where two fit and the grid has more
    blocks than SMs)."""
    if instance is None:
        instance = ("control" if not tma_addressable(n, k)
                    or (m <= 16 and k <= SHORT_K)
                    else "stream" if m <= 64 else "wgmma")
    if instance == "control":
        return _control_plan(m, n, k, sms)
    if instance not in ("stream", "wgmma"):
        raise ValueError(f"qmatmul_plan: no instance {instance!r}")
    if not tma_addressable(n, k):
        raise ValueError(f"qmatmul_plan: K {k} and N {n} must be multiples "
                         f"of 16 for the {instance} instance")
    kst = -(-k // BK)
    max_splits = max(1, min(kst, k // (16 * m)))
    cols = BOX
    if instance == "stream":
        rows = next((r for r in STREAM_ROWS if r >= m), None)
        if rows is None:
            raise ValueError(f"qmatmul_plan: the stream instance takes at "
                             f"most {STREAM_ROWS[-1]} rows, not {m}")
        tiles = -(-n // BOX)
        splits = max(1, min(max_splits, sms // tiles))
        two = rows <= 16 and tiles * splits > sms
    elif n <= NARROW and k <= NARROW:
        rows = (NARROW_ROWS[0] if -(-m // NARROW_ROWS[0]) <= sms
                else NARROW_ROWS[1])
        return QmmPlan(instance, m, n, k, NARROW, rows, 32 * -(-k // 32), 1,
                       1)
    else:
        def grid(rows, boxes=None):
            m_tiles = -(-m // rows)
            boxes = boxes or (2 if -(-n // BOX) >= 2
                              and 2 * (-(-n // (2 * BOX))) * m_tiles >= sms
                              else 1)
            tiles = -(-n // (BOX * boxes)) * m_tiles
            splits = (1 if 2 * tiles >= sms
                      else max(1, min(max_splits, sms // tiles)))
            return rows, boxes, tiles, splits
        rows, boxes, tiles, splits = grid(WGMMA_ROWS[1])
        half = grid(WGMMA_ROWS[0], boxes=boxes)
        if half[2] * half[3] <= sms:        # one wave of 64-row blocks
            rows, boxes, tiles, splits = half
        cols = BOX * boxes
        two = False
    stage = cols * BK + rows * BK
    ring = _RING_TWO if two else _RING_ONE
    stages = max(1, min(-(-kst // splits), ring // stage))
    return QmmPlan(instance, m, n, k, cols, rows, BK, splits, stages)


def _workspace(dev, plan: QmmPlan):
    """Null pointers for an unsplit launch; else the int32 M x N workspace
    and one ticket per output tile of the plan, zeroed, which the kernel
    leaves zeroed (:func:`~repro_torch.kernels._cuda.zeroed_scratch`: one
    pair per device and stream, or per call under graph capture)."""
    if plan.splits == 1:
        return None, None
    return (_cuda.zeroed_scratch("qmatmul_workspace", dev,
                                 plan.m * plan.n).data_ptr(),
            _cuda.zeroed_scratch("qmatmul_tickets", dev,
                                 plan.tiles).data_ptr())


def _table(act_spec: Optional[TableSpec], dev):
    """The epilogue's table as the kernels take it: (values or None, n,
    lo, step_inv, indexing); ``step_inv`` rounded to f32 once, on the
    host, as the plain versions do."""
    if act_spec is None:
        return None, 0, 0.0, 0.0, 0
    if act_spec.n > MAX_TABLE:
        raise ValueError(f"activation table of {act_spec.n} entries "
                         f"exceeds the kernel's {MAX_TABLE}")
    return (get_table(act_spec).values(dev), act_spec.n, act_spec.lo,
            1.0 / act_spec.step, INDEXING.index(act_spec.indexing))


def _vector(s, n: int, what: str, device) -> torch.Tensor:
    """A scale given as scalar, (n,), (n, 1) or (1, n) -> contiguous (n,) f32."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.numel() == 1:
        return s.reshape(1).expand(n).contiguous()
    if s.numel() != n:
        raise ValueError(f"{what} has {s.numel()} values, expected 1 or {n}")
    return s.reshape(n).contiguous()


def qmatmul(a_data: torch.Tensor, b_data: torch.Tensor, a_scale, b_scale,
            bias: Optional[torch.Tensor] = None, out_dtype=torch.float32, *,
            act_spec: Optional[TableSpec] = None,
            act_gated: bool = False,
            plan: Optional[QmmPlan] = None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 with row/column scales -> (M, N) float.

    ``a_scale`` as (M, 1) or scalar, ``b_scale`` as (1, N) or scalar;
    ``bias`` (N,); ``act_spec`` applies a LUT activation in the epilogue
    (``act_gated``: ``y * table(y)``).  ``out_dtype`` f32 or bf16.
    ``plan`` forces a launch (default :func:`qmatmul_plan`'s, the control
    for operands that are not 16-byte aligned; another tile, split or
    ring is ``dataclasses.replace`` of a plan, which the kernel's launcher
    checks); one counted launch either way.
    """
    if a_data.device.type == "cpu":
        return qmatmul_plain(a_data, b_data, a_scale, b_scale, bias,
                             out_dtype, act_spec=act_spec, act_gated=act_gated)
    if a_data.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {a_data.device}")
    dev = a_data.device
    if a_data.dtype != torch.int8 or b_data.dtype != torch.int8:
        raise TypeError(f"qmatmul takes int8 operands, got {a_data.dtype} "
                        f"and {b_data.dtype}")
    if a_data.ndim != 2 or b_data.ndim != 2 \
            or a_data.shape[1] != b_data.shape[0]:
        raise ValueError(f"qmatmul shapes {tuple(a_data.shape)} x "
                         f"{tuple(b_data.shape)} do not chain")
    if b_data.device != dev:
        raise ValueError("qmatmul operands live on different devices")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul writes f32 or bf16, not {out_dtype}")
    m, k = a_data.shape
    n = b_data.shape[1]
    a = a_data.contiguous()
    b = b_data.contiguous()
    sa = _vector(a_scale, m, "a_scale", dev)
    sb = _vector(b_scale, n, "b_scale", dev)
    bias_t = None if bias is None else _vector(bias, n, "bias", dev)
    table, table_n, lo, step_inv, indexing = _table(act_spec, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    sms = _cuda.sm_count(dev)
    if plan is None:
        plan = qmatmul_plan(m, n, k, sms)
        if plan.instance != "control" and (a.data_ptr() % 16
                                           or b.data_ptr() % 16):
            plan = qmatmul_plan(m, n, k, sms, instance="control")
    elif (plan.m, plan.n, plan.k) != (m, n, k):
        raise ValueError(f"qmatmul: the plan is for {plan.m} x {plan.k} x "
                         f"{plan.n}, the call {m} x {k} x {n}")
    lib = _cuda.library("qmatmul")
    ws, tickets = _workspace(dev, plan)
    args = (a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            None if bias_t is None else bias_t.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(),
            m, n, k, table_n, lo, step_inv, indexing, int(bool(act_gated)),
            int(out_dtype == torch.bfloat16))
    if plan.instance == "control":
        err = lib.qmatmul_launch(*args, plan.splits, ws, tickets,
                                 _cuda.stream_of(out))
    else:
        kind = (0 if plan.instance == "stream" else
                2 if plan.cols == NARROW else 1)
        err = lib.qmatmul_tma_launch(
            *args, kind, max(1, plan.cols // BOX), plan.rows, plan.splits,
            plan.stages, ws, tickets, _cuda.stream_of(out))
    _cuda.check(lib, err, f"qmatmul ({plan.instance})")
    _cuda.LAUNCHES["qmatmul"] += 1
    return out


#: the backward kernel's output tile (rows x columns); its partial sums
#: are one float per (column tile, row) and per (row tile, column)
BWD_TILE = 64


def qmatmul_bwd(a_data: torch.Tensor, b_data: torch.Tensor, a_scale,
                b_scale, bias: Optional[torch.Tensor], dout: torch.Tensor, *,
                act_spec: Optional[TableSpec] = None,
                act_gated: bool = False):
    """``(dsa (M,), dsb (N,), dbias (N,) or None)``, f32: the gradients of
    :func:`qmatmul`'s scales and bias given ``dout`` (M, N) (f32 or bf16).
    Two launches counted as one: the partial sums per 64 x 64 output
    tile, then their sums in tile order (deterministic)."""
    if a_data.device.type == "cpu":
        return qmatmul_bwd_plain(a_data, b_data, a_scale, b_scale, bias, dout,
                                 act_spec=act_spec, act_gated=act_gated)
    if a_data.device.type != "cuda":
        raise ValueError(f"qmatmul_bwd: unsupported device {a_data.device}")
    dev = a_data.device
    if a_data.dtype != torch.int8 or b_data.dtype != torch.int8:
        raise TypeError(f"qmatmul_bwd takes int8 operands, got "
                        f"{a_data.dtype} and {b_data.dtype}")
    m, k = a_data.shape
    n = b_data.shape[1]
    if b_data.shape[0] != k or tuple(dout.shape) != (m, n) or k == 0:
        raise ValueError(f"qmatmul_bwd shapes {tuple(a_data.shape)} x "
                         f"{tuple(b_data.shape)} -> {tuple(dout.shape)}")
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul_bwd takes an f32 or bf16 dout, not "
                        f"{dout.dtype}")
    a, b, d = a_data.contiguous(), b_data.contiguous(), dout.contiguous()
    sa = _vector(a_scale, m, "a_scale", dev)
    sb = _vector(b_scale, n, "b_scale", dev)
    bias_t = None if bias is None else _vector(bias, n, "bias", dev)
    dsa = torch.empty(m, dtype=torch.float32, device=dev)
    dsb = torch.empty(n, dtype=torch.float32, device=dev)
    dbias = None if bias is None else torch.empty_like(dsb)
    if m == 0 or n == 0:
        return (dsa.zero_(), dsb.zero_(),
                None if dbias is None else dbias.zero_())
    table, table_n, lo, step_inv, indexing = _table(act_spec, dev)
    mt, nt = -(-m // BWD_TILE), -(-n // BWD_TILE)
    part_m = torch.empty(nt * m, dtype=torch.float32, device=dev)
    part_n = torch.empty(mt * n, dtype=torch.float32, device=dev)
    part_b = None if bias is None else torch.empty_like(part_n)
    lib = _cuda.library("qmatmul_bwd")
    err = lib.qmatmul_bwd_launch(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        None if bias_t is None else bias_t.data_ptr(),
        None if table is None else table.data_ptr(), d.data_ptr(),
        part_m.data_ptr(), part_n.data_ptr(),
        None if part_b is None else part_b.data_ptr(), dsa.data_ptr(),
        dsb.data_ptr(), None if dbias is None else dbias.data_ptr(),
        m, n, k, table_n, lo, step_inv, indexing, int(bool(act_gated)),
        int(d.dtype == torch.bfloat16), _cuda.stream_of(dsa))
    _cuda.check(lib, err, "qmatmul_bwd")
    _cuda.LAUNCHES["qmatmul_bwd"] += 1
    return dsa, dsb, dbias


def _grad_as(d: Optional[torch.Tensor], like: torch.Tensor,
             needed: bool) -> Optional[torch.Tensor]:
    """A scale's or bias's gradient ``d`` in the shape and dtype of the
    tensor it belongs to (summed where that was a scalar)."""
    if d is None or not needed:
        return None
    if like.numel() != d.numel():
        d = d.sum()
    return d.reshape(like.shape).to(like.dtype)


class QmatmulFn(torch.autograd.Function):
    """``fwd(a, b, sa, sb, bias) -> out`` with the gradients of ``sa``,
    ``sb`` and ``bias`` from ``bwd(a, b, sa, sb, bias, dout) -> (dsa,
    dsb, dbias)``; ``a`` and ``b`` (int8) get none.  A backend's forward
    and backward (with the epilogue's table bound in), chosen by
    :func:`repro_torch.kernels.ops.qmatmul`."""

    @staticmethod
    def forward(ctx, a, b, sa, sb, bias, fwd, bwd):
        ctx.save_for_backward(a, b, sa, sb, bias)
        ctx.bwd = bwd
        return fwd(a, b, sa, sb, bias)

    @staticmethod
    def backward(ctx, dout):
        a, b, sa, sb, bias = ctx.saved_tensors
        dsa, dsb, dbias = ctx.bwd(a, b, sa, sb, bias, dout)
        need = ctx.needs_input_grad
        return (None, None, _grad_as(dsa, sa, need[2]),
                _grad_as(dsb, sb, need[3]), _grad_as(dbias, bias, need[4]),
                None, None)
