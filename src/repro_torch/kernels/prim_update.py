"""CUDA kernels: masked first-index argmin for Prim's greedy selection,
and the whole ``vat`` Prim ordering in one launch.

The port of ``repro/kernels/prim_update.py::masked_argmin_pallas``.  The
kernel is ``csrc/prim_update.cu``: one launch, one CTA up to 4,096 lanes,
a packed (value, index) key so the first index wins ties; above that a
second one-CTA pass reduces the per-CTA keys.  The pair is written to a
device buffer and returned as 0-d CUDA tensors, so Prim's loop never waits
on the host.  A (b, n) batch, the counterpart of the reference's vmapped
kernel, is the same launch pair with the lane as a grid axis.

``vat_prim_order_cuda`` runs the loop those argmins drive
(``ref.vat_prim_order_ref``) in one launch: one thread-block cluster per
matrix, each CTA keeping the frontier of its slice of lanes in shared
memory, takes every step's argmin with the same packed key, exchanged
through distributed shared memory.  ``prim_cluster_size`` picks the
cluster's size by n on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import check_cuda, check_lanes


def masked_argmin_cuda(vals: torch.Tensor, mask: torch.Tensor):
    """(min over lanes where ``mask`` is False, its index), on the card.

    Args:
      vals: (n,) or (b, n) contiguous float32 CUDA tensor, n >= 1, no NaN;
        a (b, n) stack is reduced row by row, 1 <= b <= ``MAX_LANES``.
      mask: bool CUDA tensor of vals' shape; True lanes are excluded.

    Returns:
      (value f32, index int64), 0-d for one vector and (b,) for a stack,
      views of one (b, 2) device buffer; (+inf, 0) where every lane is
      masked.  Row z of a stack equals the call on that row bit for bit.
    """
    check_cuda(vals, "vals")
    check_cuda(mask, "mask")
    if vals.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError(f"want float32 vals and bool mask, got {vals.dtype} "
                         f"and {mask.dtype}")
    if vals.dim() not in (1, 2) or mask.shape != vals.shape \
            or vals.shape[-1] == 0:
        raise ValueError(f"want (n,) or (b, n) vals and mask with n >= 1, "
                         f"got {tuple(vals.shape)} and {tuple(mask.shape)}")
    b = vals.shape[0] if vals.dim() == 2 else 1
    check_lanes(b)
    n = vals.shape[-1]
    lib = _build.library()
    chunk = _build.MASKED_ARGMIN_CHUNK
    out = torch.empty((b, 2), dtype=torch.int64, device=vals.device)
    partial = (torch.empty(b * -(-n // chunk), dtype=torch.int64,
                           device=vals.device) if n > chunk else out)
    err = lib.repro_masked_argmin(
        vals.data_ptr(), mask.data_ptr(), b, n, partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "masked_argmin")
    _build.LAUNCHES["masked_argmin"] += 1
    value = out.view(torch.float32)[:, 2]   # the low half of out[:, 1]
    if vals.dim() == 1:
        return value[0], out[0, 0]
    return value, out[:, 0]


#: Cluster sizes the Prim kernel is built for (16 is Hopper's non-portable
#: size), and the most lanes one CTA's shared memory holds
#: (``PRIM_SLICE_MAX`` of csrc/prim_update.cu): a cluster of C CTAs orders
#: n <= C * SLICE_MAX.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SLICE_MAX = 40_960

#: (largest n, preferred cluster size): the fastest C at n = 128, 512,
#: 2,048, 4,096 and 16,384 on an H100 80GB HBM3 at 700 W by
#: ``tools/prim_order_phases.py`` (PERF.md section 6, row 3').
CLUSTER_BY_N = ((256, 1), (1_024, 4), (2_048, 8), (None, 16))

#: Row loads a thread of the Prim kernel keeps in flight (``PRIM_UNROLL``).
UNROLL = 8

_RESIDENT: dict = {}


def prim_cluster_size(n: int) -> int:
    """The cluster size C the Prim kernel takes for a matrix of n lanes.

    C is ``CLUSTER_BY_N``'s choice at n, raised to the least C whose slices
    hold n lanes (``n <= C * SLICE_MAX``) and cut to the largest power of
    two no larger than n.  A stack of b matrices takes the same C: b
    clusters, in waves where the device holds fewer at once.

    Raises:
      ValueError: n < 1, or n larger than the largest cluster holds.
    """
    if n < 1:
        raise ValueError(f"want n >= 1, got n={n}")
    need = next((c for c in CLUSTER_SIZES if c * SLICE_MAX >= n), None)
    if need is None:
        raise ValueError(f"the Prim kernel orders at most "
                         f"{CLUSTER_SIZES[-1] * SLICE_MAX} lanes, got n={n}")
    c = next(c for top, c in CLUSTER_BY_N if top is None or n <= top)
    return max(need, min(c, 1 << (n.bit_length() - 1)))


def prim_block_threads(n: int, c: int, bulk: bool = False) -> int:
    """Threads of one CTA of the Prim kernel at (n, c), a multiple of 32
    from 128 to 1,024: a thread a lane for a slice of up to 512 lanes read
    by loads, else ``UNROLL`` lanes a thread (one round of loads, or of
    reads of the bulk copy's buffer).  At the (n, C) ``CLUSTER_BY_N``
    picks, the sweep of ``tools/prim_order_phases.py`` found these sizes
    the fastest or within 6 % of it."""
    lanes = -(-n // c)
    per = UNROLL if bulk or lanes > 512 else 1
    return min(1024, max(128, -(-lanes // (32 * per)) * 32))


def prim_slice(n: int, c: int) -> int:
    """Lanes a CTA owns in a cluster of c: ceil(n / c) rounded up to 32."""
    return -(-(-(-n // c)) // 32) * 32


def prim_bulk(n: int, c: int) -> bool:
    """Whether the kernel may bring each pivot row's slice in by one bulk
    copy at (n, c): 16-byte rows (n % 4 == 0) and a slice whose row buffer
    fits beside its frontier (9 bytes a lane in the shared memory 5 *
    ``SLICE_MAX`` bytes allow)."""
    return n % 4 == 0 and 9 * prim_slice(n, c) <= 5 * SLICE_MAX


def _resident_clusters(c: int, n: int, threads: int, bulk: bool) -> int:
    """Clusters of the Prim kernel's launch at (c, n, threads, bulk) the
    current device holds at once (``cudaOccupancyMaxActiveClusters``),
    queried once a device and launch shape."""
    key = (torch.cuda.current_device(), c, prim_slice(n, c), threads, bulk)
    if key not in _RESIDENT:
        count = _build.library().repro_vat_prim_max_clusters(
            c, n, threads, int(bulk))
        if count < 0:
            _build.check(-count, "vat_prim_order occupancy")
        _RESIDENT[key] = count
    return _RESIDENT[key]


def _l2_bytes() -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size


def prim_plan(n: int, *, cluster: int | None = None,
              bulk: bool | None = None,
              aligned: bool = True) -> tuple[int, int, bool]:
    """(cluster size, threads a CTA, bulk row copy) of the Prim kernel's
    launch for a matrix, or a stack of matrices, of n lanes on the current
    device: ``prim_cluster_size``, ``prim_block_threads`` and, where not
    given, a bulk copy where ``prim_bulk`` allows it on 16-byte aligned R
    (``aligned``) and one matrix outgrows the card's L2.  On an H100 80GB
    HBM3 at 700 W (``tools/prim_order_phases.py``, PERF.md section 6) the
    copy beat each thread's loads at the C chosen where one matrix's rows
    come from HBM (n = 4,096 and 16,384) and lost where they come from L2
    (n <= 2,048), also in stacks of 8 x 2,048 and 32 x 1,024 (128 MiB
    together); only at 32 x 2,048 did it win (7 %).

    Raises:
      ValueError: ``bulk=True`` where ``prim_bulk`` or ``aligned`` forbids.
      RuntimeError: the device holds no cluster of this launch; nothing
        falls back to a smaller cluster.
    """
    if cluster is None:
        cluster = prim_cluster_size(n)
    allowed = aligned and prim_bulk(n, cluster)
    if bulk is None:
        bulk = allowed and 4 * n * n > _l2_bytes()
    elif bulk and not allowed:
        raise ValueError(f"a bulk row copy needs n % 4 == 0, 16-byte "
                         f"aligned R and a slice of at most "
                         f"{5 * SLICE_MAX // 9} lanes; n={n}, "
                         f"cluster={cluster}, aligned={aligned}")
    threads = prim_block_threads(n, cluster, bulk)
    if _resident_clusters(cluster, n, threads, bulk) < 1:
        raise RuntimeError(f"the device holds no cluster of {cluster} CTAs "
                           f"of the Prim kernel at n={n}, {threads} threads "
                           f"a CTA, bulk={bulk}")
    return cluster, threads, bulk


def vat_prim_order_cuda(R: torch.Tensor, i0: torch.Tensor, *,
                        cluster: int | None = None,
                        bulk: bool | None = None) -> torch.Tensor:
    """Prim's VAT order of R from seed i0, on the card, in one launch.

    Args:
      R: (n, n) or (b, n, n) contiguous finite float32 CUDA tensor,
        1 <= n <= 16 * ``SLICE_MAX``, 1 <= b <= ``MAX_LANES``.
      i0: the seed, int64 on R's device: one element for a matrix, (b,) for
        a stack.
      cluster: CTAs in the cluster that orders one matrix, one of
        ``CLUSTER_SIZES``; None lets ``prim_cluster_size`` choose.  Every C
        gives the same bits.
      bulk: bring each pivot row's slice into shared memory by one bulk
        copy (True) or by each thread's loads (False); None lets
        ``prim_plan`` choose.  Both give the same bits.

    Returns:
      (n,) int64 order, or (b, n) for a stack: ``ref.vat_prim_order_ref``'s
      bits, the loop of ``masked_argmin`` steps; lane z equals the call on
      R[z] alone.

    Raises:
      ValueError: bad shapes or types, a C outside ``CLUSTER_SIZES`` or
        too small for n (``n > C * SLICE_MAX``), ``bulk=True`` where
        ``prim_plan`` forbids it.
      RuntimeError: the device holds no cluster of C CTAs, or the launch
        failed.
    """
    check_cuda(R, "R")
    check_cuda(i0, "i0")
    if R.dtype != torch.float32 or R.dim() not in (2, 3) \
            or R.shape[-1] != R.shape[-2] or R.shape[-1] == 0:
        raise ValueError(f"want a float32 (n, n) or (b, n, n) R with n >= 1, "
                         f"got {R.dtype} {tuple(R.shape)}")
    b = R.shape[0] if R.dim() == 3 else 1
    n = R.shape[-1]
    check_lanes(b)
    if i0.dtype != torch.int64 or i0.numel() != b:
        raise ValueError(f"want {b} int64 seed(s), got {i0.dtype} "
                         f"{tuple(i0.shape)}")
    if cluster is not None and (cluster not in CLUSTER_SIZES
                                or cluster * SLICE_MAX < n):
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES} with "
                         f"cluster * {SLICE_MAX} >= n={n}, got {cluster}")
    cluster, threads, bulk = prim_plan(n, cluster=cluster, bulk=bulk,
                                       aligned=R.data_ptr() % 16 == 0)
    order = torch.empty((b, n), dtype=torch.int64, device=R.device)
    err = _build.library().repro_vat_prim_order(
        R.data_ptr(), i0.contiguous().data_ptr(), b, n, cluster, threads,
        int(bulk), order.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "vat_prim_order")
    _build.LAUNCHES["vat_prim_order"] += 1
    return order if R.dim() == 3 else order[0]
