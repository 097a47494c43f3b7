"""What the port's kernels and steps compute: FLOPs and bytes.

Two parts.

**The kernels' formulas** (``*_work`` -> ``(bytes, flops)``), the
least work each hand-written kernel must do on its inputs: each input
read once and each output written once; products at 2mnk; attention
over the (q head, key) pairs it computes (4 hd flops a pair forward:
QKᵀ and PV; 6 and 8 for the dq and dk/dv backward, which recompute
QKᵀ); the SSD scan and its gradient over the kernel's own 32-row
chunks.  Where the work depends on the data (a decode's live keys) it
counts what the inputs need.  ``*_cost`` turn them into the least time
the H100 could take (:func:`bound`: the larger of the bytes over its
memory rate and the operations over its peak rate for their type;
NVIDIA's data sheet, SXM part, dense).  ``chip_smoke.py`` holds every
kernel's time against these bounds.

**A count of one step** (:class:`CostCounter`, a ``TorchDispatchMode``)
for the dry run (``launch/dryrun.py``), the port's counterpart of XLA's
``cost_analysis()`` of a compiled step:

* FLOPs: every aten matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) by ``torch.utils.flop_counter``'s formulas (2mnk), and
  ``_grouped_mm`` (the MoE FFN's grouped product) at 2 · rows · k · n
  for each group, from its group ends; plus each hand-written kernel's
  formula above, which its wrapper (``kernels/ops.py``, and the
  backwards of ``FlashAttentionFn`` and ``SSDScanFn``) adds through
  :func:`counted`.  Elementwise ops, reductions and softmaxes count no
  FLOPs.  XLA counts them (an add is a FLOP, an exp several) and counts
  attention by the einsums it lowers to, masked pairs included: the
  port's FLOPs are the products' and the kernels' only.
* Bytes: the input and output bytes of each aten op that computes, as
  XLA's "bytes accessed" are the bytes each HLO op reads and writes.
  Views, aliases (``_unsafe_view`` among them) and factory ops
  (``empty``, ``zeros``, ``*_like``, ``new_*``) count 0, and so does a copy between the host and the
  card (not the device's traffic).  A gather (``index``, ``gather``,
  ``index_select``, ``embedding``) reads its indices and the rows it
  gathers and writes them; a scatter into a tensor in place
  (``index_put_``, ``scatter_``, ``index_copy_``, ``index_add_``) reads
  its indices and values and writes the values, not the whole tensor.
  Ops outside the ``aten`` namespace (the collectives) count 0: the
  dry run tallies them itself.  A hand-written kernel is a ``ctypes``
  call the dispatcher never sees; its wrapper adds its formula's bytes
  and suppresses the aten ops inside it (its plain version on the CPU,
  its scratch buffers on the card), so the CPU and the card count a
  step alike.  The MoE FFN's grouped product counts by its formula in
  the forward; its backward counts the aten ops autograd runs (a
  product per group on the CPU, ``_grouped_mm`` on the card): the
  FLOPs agree, the bytes of the two differ by the CPU's per-group
  slices and concatenation.

Nothing here imports ``triton`` or touches a card at import.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES = 3.35e12                       # HBM3, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12,          # dense tensor-core bf16
              "float32": 67e12}            # float32 outside tensor cores
# f32-accurate tensor-core products (3xTF32: three TF32 products each)
PEAK_3XTF32 = 495e12 / 3
# the SSD chunk whose flops the f32 CUDA-core bound counts (64 rows: the
# first SSD kernel's yardstick, kept so that bounds compare across kernel
# versions), and the kernel's own chunk (csrc/ssd_scan.cu kQ), whose
# flops the 3xTF32 bound, the achieved rate and the counter count
SSD_Q, SSD_KQ = 64, 32
# flops per q head x hd x attended pair: the forward (QKᵀ, PV), dq (QKᵀ,
# dO·Vᵀ, dS·K) and dk/dv (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q)
TRAIN_PER_PAIR = {"flash_attention_fwd_lse": 4, "flash_attention_dq": 6,
                  "flash_attention_dkv": 8}


def _at(nbytes: float, flops: float, peak: float):
    """(ms, "bytes" | "operations"): the least time the card could take
    for ``nbytes`` moved and ``flops`` at ``peak`` FLOP/s."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(nbytes: float, flops: float, dtype: str):
    """:func:`_at` at ``dtype``'s peak."""
    return _at(nbytes, flops, PEAK_FLOPS[dtype])


# ------------------------------------------------------------ attention
def attn_flops(q, window, per_pair=4, q_offset=0):
    """``per_pair`` flops per q head x hd x attended (q, key) pair of
    causal attention over q [B,S,H,hd] (4 for a forward: QKᵀ and PV),
    its rows at key positions ``q_offset`` onwards (a sequence-parallel
    rank's rows: only the band of those rows is counted)."""
    b, s, h, hd = q.shape
    w = window or 0
    lo, hi = q_offset + 1, q_offset + s          # row i attends min(i, w)
    if w:
        cut = min(max(w, lo - 1), hi)            # rows up to w: i pairs
        pairs = (cut * (cut + 1) - (lo - 1) * lo) // 2 \
            if cut >= lo else 0
        pairs += w * (hi - max(cut, lo - 1))
    else:
        pairs = (hi * (hi + 1) - (lo - 1) * lo) // 2
    return float(per_pair) * b * h * hd * pairs


def flash_work(q, k, window, q_offset=0):
    """K2: q read and out written once, k and v read once."""
    nbytes = 2 * q.numel() * q.element_size() + \
        2 * k.numel() * k.element_size()
    return nbytes, attn_flops(q, window, 4, q_offset)


def flash_cost(args, window, dtype_name):
    q, k, _ = args
    return bound(*flash_work(q, k, window), dtype_name)


def flash_train_work(name, q, k, window, q_offset=0):
    """One training-kernel call: each input read once and each output
    written once (q-sized out/dout/dq, k-sized dk/dv, f32 [B,H,Sq] lse
    and delta); TRAIN_PER_PAIR flops per q head x hd x attended pair of
    q's rows at ``q_offset``."""
    b, s, h, hd = q.shape
    qb, kb, rows = q.numel() * q.element_size(), \
        k.numel() * k.element_size(), b * h * s * 4
    nbytes = {"flash_attention_fwd_lse": 2 * qb + 2 * kb + rows,
              "flash_attention_dq": 3 * qb + 2 * kb + 2 * rows,
              "flash_attention_dkv": 2 * qb + 4 * kb + 2 * rows}[name]
    return nbytes, attn_flops(q, window, TRAIN_PER_PAIR[name], q_offset)


def flash_train_cost(name, q, k, window, dtype_name, q_offset=0):
    return bound(*flash_train_work(name, q, k, window, q_offset),
                 dtype_name)


# --------------------------------------------------------------- decode
def decode_work(q, lengths, L, row_bytes, index_bytes, window):
    """One decode call: q read and out written once, each live K/V row
    (``row_bytes`` per token for K and V each) read once, the index
    tensors read once; 4 flops per q head x hd x attended key.  Reads the
    lengths (a host sync on the card)."""
    live = [min(int(n), L) for n in lengths.tolist()]
    attended = [min(x, window) if window else x for x in live]
    nbytes = (2 * q.numel() * q.element_size() + 2 * sum(live) * row_bytes
              + index_bytes)
    return nbytes, 4 * q.shape[1] * q.shape[2] * sum(attended)


def paged_work(args, window):
    """K1: (q, k_pages, v_pages, block_tables, lengths)."""
    q, k, _, bt, ln = args
    return decode_work(q, ln, bt.shape[1] * k.shape[1],
                       k.shape[2] * k.shape[3] * k.element_size(),
                       (bt.numel() + ln.numel()) * 4, window)


def decode_cost(args, window, dtype_name):
    return bound(*paged_work(args, window), dtype_name)


def paged_q8_work(args, window):
    """K3: int8 values + one bf16 scale per (token, kv head), for K and
    V; (q, k, k_scale, v, v_scale, block_tables, lengths)."""
    q, kq, _, _, _, bt, ln = args
    return decode_work(q, ln, bt.shape[1] * kq.shape[1],
                       kq.shape[2] * (kq.shape[3] + 2),
                       (bt.numel() + ln.numel()) * 4, window)


def decode_q8_cost(args, window, dtype_name):
    return bound(*paged_q8_work(args, window), dtype_name)


def dense_work(args, window=0):
    """K6: (q, k_cache, v_cache, n_valid)."""
    q, k, _, nv = args
    return decode_work(q, nv, k.shape[1],
                       k.shape[2] * k.shape[3] * k.element_size(),
                       nv.numel() * 4, window)


def dense_cost(args, window, dtype_name):
    return bound(*dense_work(args, window), dtype_name)


def dense_q8_work(args, window=0):
    """K7: (q, k, k_scale, v, v_scale, n_valid)."""
    q, k, _, _, _, nv = args
    return decode_work(q, nv, k.shape[1], k.shape[2] * (k.shape[3] + 2),
                       nv.numel() * 4, window)


def dense_q8_cost(args, window, dtype_name):
    return bound(*dense_q8_work(args, window), dtype_name)


# -------------------------------------------------------------- SSD scan
def ssd_flops(b, s, nh, hd, ds, q):
    """The flops of the chunked SSD over chunks of ``q`` rows: per batch
    row and chunk of n rows, 2n²·ds for C·Bᵀ, once (B and C are shared
    by every head), and per head 2n²·hd (with x·dt) + 2n·hd·ds (the
    inter-chunk term) + 2n·hd·ds (the state update)."""
    rows = [min(q, s - r) for r in range(0, s, q)]
    return b * sum(2 * n * n * ds + nh * (2 * n * n * hd + 4 * n * hd * ds)
                   for n in rows)


def ssd_work(x, B, st):
    """K4: x, dt, A, B, C (and the initial state) read once, y and the
    final state written once; the flops of the kernel's 32-row chunks."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    el = x.element_size()
    nbytes = (2 * x.numel() * el + b * s * nh * 4 + nh * 4
              + 2 * b * s * ds * el
              + b * nh * hd * ds * 4 * (1 if st is None else 2))
    return nbytes, ssd_flops(b, s, nh, hd, ds, SSD_KQ)


def ssd_cost(x, B, st, dtype_name):
    """Bounds of one scan.  -> ((bound ms, bound_by) at the f32
    CUDA-core peak over 64-row chunks, the first kernel's yardstick),
    ((bound ms, bound_by) at the rate of the f32-accurate 3xTF32
    tensor-core products the kernel issues, 495/3 TFLOP/s, over the
    kernel's own 32-row chunks), and those chunks' flops."""
    b, s, nh, hd = x.shape
    nbytes, flops = ssd_work(x, B, st)
    return (bound(nbytes, ssd_flops(b, s, nh, hd, B.shape[-1], SSD_Q),
                  dtype_name),
            _at(nbytes, flops, PEAK_3XTF32), flops)


def ssd_bwd_flops(b, s, nh, hd, ds, q=SSD_KQ):
    """The flops of the SSD backward over chunks of ``q`` rows, reckoned
    as :func:`ssd_flops` does: per batch row and chunk of n rows, the
    n x n tile C·Bᵀ once (2n²·ds: B and C are shared by every head, and
    the kernel computes it once into a workspace every head reads, as K4
    does), and per head the tile dy·uᵀ (2n²·hd), the tiles' products with
    dy, B and C (2n²·hd + 4n²·ds), and five n x hd x ds products (the
    recomputed state, dS'·B, Sᵀ·dy, dS'ᵀ·u and the carried dS:
    10n·hd·ds)."""
    rows = [min(q, s - r) for r in range(0, s, q)]
    return b * sum(2 * n * n * ds
                   + nh * (4 * n * n * hd + 4 * n * n * ds
                           + 10 * n * hd * ds)
                   for n in rows)


def ssd_bwd_work(x, B, st, dfinal):
    """K4b: x, dt, A, B, C, dy (and the initial state and dfinal) read
    once, dx, ddt, dA, dB, dC (and dinit) written once, all float32."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    state = b * nh * hd * ds
    n_in = 2 * x.numel() + b * s * nh + nh + 2 * b * s * ds \
        + state * ((st is not None) + (dfinal is not None))
    n_out = x.numel() + b * s * nh + nh + 2 * b * s * ds \
        + state * (st is not None)
    return 4 * (n_in + n_out), ssd_bwd_flops(b, s, nh, hd, ds)


def ssd_bwd_cost(x, B, st, dfinal):
    """Bounds of one backward.  -> ((bound ms, bound_by) at the f32
    CUDA-core peak, (bound ms, bound_by) at the rate of the f32-accurate
    3xTF32 tensor-core products the kernel issues (495/3 TFLOP/s),
    flops)."""
    nbytes, flops = ssd_bwd_work(x, B, st, dfinal)
    return bound(nbytes, flops, "float32"), \
        _at(nbytes, flops, PEAK_3XTF32), flops


# ---------------------------------------------------------------- anneal
def anneal_work(n_inst, chains, n, mb, props, incremental):
    """Bytes and operations of one anneal: reqc and n_valid read once,
    each chain's draw rows read once, its best schedule and G written
    once; per proposal (every proposal of the schedule, as no chain of
    a contended instance meets every SLO) the incremental path rebuilds
    3 rows of mb members at 10 flops each, takes an N-long scan and
    three N-long sums and compares each of the N slacks with its batch's
    wait once (no row needs sorting for that count); the full path 25
    flops per position."""
    nbytes = n_inst * (n * 11 * 4 + 4) + n_inst * chains * (
        props * 16 + n * 5 + 4)
    per = 30 * mb + 4 * n + n if incremental else 25 * n
    return nbytes, n_inst * chains * props * per


# ------------------------------------------------------- counting a step
# aten products counted by torch.utils.flop_counter's formulas
PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")
_GATHERS = frozenset(("index", "_unsafe_index", "index_select", "gather",
                      "embedding", "take"))
_SCATTERS = frozenset(("index_put_", "index_put", "_index_put_impl_",
                       "index_copy_", "index_copy", "scatter_", "scatter",
                       "scatter_add_", "scatter_add", "scatter_reduce_",
                       "scatter_reduce", "index_add_", "index_add"))
_FACTORIES = frozenset(("empty_like", "zeros_like", "ones_like",
                        "full_like", "rand_like", "randn_like",
                        "randint_like", "new_empty", "new_empty_strided",
                        "new_zeros", "new_ones", "new_full"))
_COPIES = frozenset(("_to_copy", "copy_", "_copy_from"))
# views whose schema does not say so
_VIEWS = frozenset(("_unsafe_view",))

# the counters in force, innermost last (a kernel's wrapper adds to it)
_ACTIVE: List["CostCounter"] = []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def grouped_mm_flops(a, b, offs=None) -> int:
    """``torch._grouped_mm(a, b, offs)``: 2 · rows · k · n for each group
    (the groups' ends ``offs``; rows past the last end compute nothing)."""
    if a.dim() == 3 and b.dim() == 3:
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    end = int(offs[-1]) if offs is not None and offs.numel() else 0
    if a.dim() == 2 and b.dim() == 3:          # [T, k] x [G, k, n]
        return 2 * end * a.shape[1] * b.shape[2]
    if a.dim() == 3 and b.dim() == 2:          # [G, m, k] x [k, N] by columns
        return 2 * a.shape[1] * a.shape[2] * end
    return 2 * a.shape[0] * end * b.shape[1]   # [m, T] x [T, n] -> [G, m, n]


class CostCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run while it is entered,
    and each hand-written kernel's formula (module docstring).
    ``flops`` / ``bytes`` are the totals; ``by_kernel`` maps each kernel
    to ``[calls, bytes, flops]`` and ``by_op`` each aten op that counted
    alike; ``product_flops`` / ``aten_bytes`` are the aten ops' part."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.product_flops = 0
        self.aten_bytes = 0
        self.by_kernel: Dict[str, List[int]] = {}
        self.by_op: Dict[str, List[int]] = {}
        self._quiet = 0

    @property
    def flops(self) -> int:
        return self.product_flops + sum(v[2] for v in self.by_kernel.values())

    @property
    def bytes(self) -> int:
        return self.aten_bytes + sum(v[1] for v in self.by_kernel.values())

    def kernel_flops(self, *names) -> int:
        return sum(self.by_kernel.get(n, (0, 0, 0))[2] for n in names)

    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "product_flops": self.product_flops,
                "aten_bytes": self.aten_bytes,
                "kernels": {k: {"calls": v[0], "bytes": v[1], "flops": v[2]}
                            for k, v in sorted(self.by_kernel.items())},
                "ops": {k: {"calls": v[0], "bytes": v[1], "flops": v[2]}
                        for k, v in sorted(self.by_op.items())}}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def quiet(self):
        """Count no aten op inside (a kernel's plain version, its
        wrapper's buffers, its formula's own arithmetic)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def add_kernel(self, name: str, nbytes: int, flops: int):
        row = self.by_kernel.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += int(nbytes)
        row[2] += int(flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet and func.namespace == "aten":
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._schema.name.split("::")[-1]
        flops = 0
        if name in PRODUCTS:
            flops = int(self._formulas[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif name == "_grouped_mm":
            # the dispatcher hands offs positionally (autograd's calls too)
            flops = grouped_mm_flops(*args[:2], args[2] if len(args) > 2
                                     else kwargs.get("offs"))
        nbytes = self._op_bytes(func, name, args, kwargs, out)
        if flops or nbytes:
            self.product_flops += flops
            self.aten_bytes += nbytes
            row = self.by_op.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += nbytes
            row[2] += flops

    @staticmethod
    def _op_bytes(func, name, args, kwargs, out) -> int:
        rets = func._schema.returns
        if name in _VIEWS or rets and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets):
            return 0                                  # a view or alias
        ins = _tensors((args, kwargs))
        if not ins or name in _FACTORIES:
            return 0                                  # a factory
        outs = _tensors(out)
        if name in _COPIES and len({t.device for t in ins + outs}) > 1:
            return 0                                  # host <-> card
        if name in _GATHERS:
            idx = [t for t in ins if not t.is_floating_point()]
            return sum(map(_nbytes, idx)) + 2 * sum(map(_nbytes, outs))
        if name in _SCATTERS:
            rest = ins[1:]                  # the indices and the values
            vals = [t for t in rest if t.is_floating_point()] or rest[-1:]
            return sum(map(_nbytes, rest)) + sum(map(_nbytes, vals))
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def active():
    """The innermost :class:`CostCounter` in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def counted(run: Callable, *kernels: Tuple[str, Callable]):
    """``run()``: a hand-written kernel's launch or its plain version.
    Under a :class:`CostCounter` each of ``kernels``, a (name, work)
    pair whose ``work()`` gives (bytes, flops), is added to the count and
    the aten ops inside (``run`` and the formulas) are not counted.
    Without one, ``run()`` alone."""
    mode = active()
    if mode is None:
        return run()
    with mode.quiet():
        for name, work in kernels:
            mode.add_kernel(name, *work())
        return run()
