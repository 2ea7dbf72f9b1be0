# coding=utf-8
"""How `chip_smoke.py` and `bench_ln_kmedoids.py` time a kernel call and
compute the least time the card could take for it.

* `time_ms`: the median device time of a call by CUDA events, the L2
  cache flushed before each launch and the card held busy by a sleep
  kernel while the host enqueues it.
* `host_us_per_call`: the host's microseconds a call, no synchronisation
  between calls.
* `bound`: the larger of the bytes a function must move over the card's
  memory rate and its operations over the peak rate for their type
  (`card_peaks`, `tf32_peak`); `layernorm_bound` and `kmedoids_bound`
  count them for kernels C and E.
* `layernorm_times`: kernel C's row (its time, the plain version's and
  `F.layer_norm`'s) on one input; `LAYERNORM_FWD_SHAPES`, every input
  shape `chip_smoke.py` times C at, which `bench_ln_kmedoids.py` times too.
* `quick_gelu_times`: kernel F's rows, forward and backward, beside the
  eager composition and F's byte bound; `QUICK_GELU_SHAPES`, the shapes
  `chip_smoke.py` times it at.

Needs a CUDA device to run; importing it needs only torch.
"""
from __future__ import annotations

import time

import torch

# card data sheets (dense peaks; NVIDIA's published figures):
# memory bytes/s, bf16 tensor-core flop/s, fp32 (non-tensor) flop/s
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H200": (4.8e12, 989e12, 67e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM (80GB HBM3)
}
# a timed launch longer than twice the median and this is printed
SLOW_LAUNCH_MS = 0.05
SLEEP_CYCLES = 4_000_000          # ~2 ms at the H100's ~1.98 GHz boost clock
# (label, rows, width, dtype) of kernel C's inputs in `chip_smoke.py`: its
# `ln_cases` (serving), `lnb_cases` (training), the ViT-B/16, activity and
# header phases, TP_LAYERNORM_CASES (SP) and PP_LAYERNORM_CASES with leg
# (b'')'s shapes (PP); the script fails on a shape it times that is not here
LAYERNORM_FWD_SHAPES = (
    ("serving vision blocks 1-6", 19200, 768, torch.bfloat16),
    ("serving vision blocks 7-12", 9600, 768, torch.bfloat16),
    ("serving ln_post", 192, 768, torch.bfloat16),
    ("search text, 4 queries", 128, 512, torch.bfloat16),
    ("training vision blocks 1-6", 76800, 768, torch.bfloat16),
    ("training vision blocks 7-12", 38400, 768, torch.bfloat16),
    ("training ln_post", 768, 768, torch.bfloat16),
    ("training text", 4096, 512, torch.bfloat16),
    ("ViT-B/16 blocks 1-6", 302592, 768, torch.bfloat16),
    ("ViT-B/16 blocks 7-12", 123648, 768, torch.bfloat16),
    ("activity", 384000, 768, torch.bfloat16),
    ("seqTransf header", 768, 512, torch.float32),
    ("cross header", 114688, 512, torch.float32),
    ("SP tp 4", 19968, 768, torch.bfloat16),
    ("SP text", 1024, 512, torch.bfloat16),
    ("PP vision blocks 1-6", 4800, 768, torch.bfloat16),
    ("PP vision blocks 7-12", 2400, 768, torch.bfloat16),
    ("PP text", 256, 512, torch.bfloat16),
    ("PP gloo vision blocks 7-12", 1200, 768, torch.bfloat16),
)

# (label, rows, width) of kernel F's bf16 inputs in `chip_smoke.py`: the
# MLP's c_fc outputs of ViT-B/16 and ViT-B/32 at batch 128 and the text
# tower's
QUICK_GELU_SHAPES = (
    ("ViT-B/16 blocks 1-6", 302592, 3072),
    ("ViT-B/16 blocks 7-12", 123648, 3072),
    ("ViT-B/32 blocks 1-6", 76800, 3072),
    ("ViT-B/32 blocks 7-12", 38400, 3072),
    ("text", 4096, 2048),
)


def card_peaks(name: str):
    """(memory bytes/s, bf16 flop/s, fp32 flop/s) of the card `name`."""
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return CARD_PEAKS["H100"]


def tf32_peak(peaks) -> float:
    """The TF32 tensor-core flop/s of a card with `card_peaks` `peaks`:
    half its bf16 rate on Hopper (495 of 989 TFLOP/s dense on the H100
    SXM)."""
    return peaks[1] / 2


def bound(bytes_moved: float, ops: float, op_peak: float, mem_rate: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = bytes_moved / mem_rate, ops / op_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush, iters=10, warmup=3):
    """Median device time of `fn` in ms by CUDA events.  Before each launch
    the L2 cache is flushed (`flush.zero_()`: the main path's inputs mostly
    come from device memory) and a sleep kernel holds the card busy while
    the host enqueues the events and `fn`, so a launch's host overhead is
    not timed as device time.  (`fn`s that read results back to the host,
    like the plain k-medoids stop test, are timed with their waits.)  The
    median, not the mean: a launch the host enqueues only after the sleep
    has ended (its thread held off the CPU longer than the sleep) times
    that wait as device time; such a launch is printed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = sorted(times)[iters // 2]
    if max(times) > 2 * med + SLOW_LAUNCH_MS:
        print(f"time_ms: launches of {[round(t, 4) for t in times]} ms, "
              f"median {med:.4f}: a launch waited on the host")
    return med


def host_us_per_call(fn, calls=1000):
    """Host microseconds per call of `fn`: `time.perf_counter` around
    `calls` calls with no synchronisation between them, divided."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def layernorm_library(x, w, b):
    """`F.layer_norm` on x as it is, the yardstick of kernel C: gamma and
    beta cast to x's dtype, since PyTorch refuses fp32 ones with a bf16 x
    on the card."""
    F = torch.nn.functional
    lw, lb = w.to(x.dtype), b.to(x.dtype)
    return lambda: F.layer_norm(x, (x.shape[-1],), lw, lb, 1e-5)


def layernorm_times(x, w, b, flush):
    """Kernel C's row numbers on x [R, D]: its time, the plain version's,
    `F.layer_norm` on x (`layernorm_library`) and on an fp32 copy of x
    with fp32 gamma and beta, by `time_ms`."""
    from .ops import layernorm_triton
    xf = x.float()
    return dict(
        ms=time_ms(lambda: layernorm_triton.layer_norm(x, w, b), flush),
        plain_ms=time_ms(lambda: layernorm_triton.layer_norm_plain(x, w, b),
                         flush),
        library_ms=time_ms(layernorm_library(x, w, b), flush),
        library_params=str(x.dtype).split(".")[-1],
        library_fp32_copy_ms=time_ms(
            lambda: torch.nn.functional.layer_norm(
                xf, (x.shape[-1],), w, b, 1e-5), flush))


def layernorm_bound(x, peaks):
    """`bound` of kernel C on x [R, D]: x read and y written once, fp32
    gamma and beta read once; 8 fp32 operations an element."""
    mem_rate, _, fp32_peak = peaks
    R, D = x.numel() // x.shape[-1], x.shape[-1]
    return bound(2 * x.numel() * x.element_size() + 2 * D * 4, 8.0 * R * D,
                 fp32_peak, mem_rate)


def _kmedoids_work(K, assign, steps):
    """Kernel E's work on this run's data that its two bounds share, from
    `assign` [B, N] and `steps` [B]: (the bytes of all but the member sums
    — of D the K medoid rows (KKZ's distances to each pick, and the
    assignment's), l2 [B, N] read once, the outputs (assign [B, N], meds
    [B, K], steps [B], int32) written once —; the fp32 operations — KKZ's
    2 a point a pick, each Lloyd step's 2 a point a medoid and 2 an entry
    of the final clusters' member sums, and the last assignment's 1 a
    point a medoid —; the sum of each segment's squared cluster sizes
    [B]; whether each segment took a Lloyd step [B])."""
    B, N = assign.shape
    counts = torch.zeros((B, K), dtype=torch.float64, device=assign.device)
    counts.scatter_add_(1, assign.long(), torch.ones_like(counts[:, :1])
                        .expand(B, N).contiguous())
    sq = (counts * counts).sum(1)
    st = steps.double().to(assign.device)
    bytes_moved = 4.0 * (B * K * N + B * N + B * N + B * K + B)
    ops = float(B * 2 * K * N + (st * (2 * N * K + 2 * sq)).sum()
                + B * N * K)
    return bytes_moved, ops, sq, st > 0


def kmedoids_bound(K, assign, steps, peaks):
    """`bound` of kernel E on B segments of N points into K clusters, from
    the run's output (`assign` [B, N], the cluster of each point, and
    `steps` [B], the Lloyd steps of each segment).  Bytes, what this run's
    data needs: `_kmedoids_work`'s, and in a segment that took a Lloyd
    step the entries among each cluster's members that the medoid update
    sums, beyond the medoid's own row, 4 bytes each.  Operations as
    `_kmedoids_work` counts them."""
    mem_rate, _, fp32_peak = peaks
    N = assign.shape[1]
    bytes_moved, ops, sq, took = _kmedoids_work(K, assign, steps)
    members = float((took.double() * (sq - N)).sum())
    return bound(bytes_moved + 4.0 * members, ops, fp32_peak, mem_rate)


def kmedoids_sector_bound(K, assign, steps, peaks):
    """`kmedoids_bound` with the member sums counted in the 32-byte sectors
    they touch, since a scattered read of one fp32 entry moves a whole
    sector: of D [B, N, N] (segment b's row n starts at element (b N + n) N
    of a sector-aligned tensor), in a segment that took a Lloyd step, for
    each cluster, each member row's distinct sectors over the cluster's
    member columns, less one member row a cluster (the medoid's, read
    among the K rows: the one with the fewest sectors is taken off); the
    rest as `_kmedoids_work` counts it."""
    mem_rate, _, fp32_peak = peaks
    B, N = assign.shape
    dev = assign.device
    a = assign.long()
    bytes_moved, ops, _, took = _kmedoids_work(K, assign, steps)
    cols = torch.arange(N, device=dev)
    residue = ((torch.arange(B, device=dev)[:, None] * N + cols) * N) % 8
    span = N // 8 + 2                     # sectors a cluster's key spans
    seg_k = torch.arange(B, device=dev)[:, None] * K + a
    sectors = 0
    fewest = torch.full((B, K), 2 ** 62, dtype=torch.int64, device=dev)
    for r in range(8):
        # distinct sectors (r + m) // 8 over each cluster's members m
        keys = torch.unique(seg_k * span + (r + cols) // 8)
        S = torch.bincount(keys // span, minlength=B * K).view(B, K)
        rows = (residue == r) & took[:, None]
        sectors += int(S.gather(1, a)[rows].sum())
        has = torch.zeros((B, K), dtype=torch.int64, device=dev).scatter_add_(
            1, a, rows.long()) > 0
        fewest = torch.where(has, torch.minimum(fewest, S), fewest)
    sectors -= int(fewest[fewest < 2 ** 62].sum())
    return bound(bytes_moved + 32.0 * sectors, ops, fp32_peak, mem_rate)


def quick_gelu_bound(x, peaks, backward: bool):
    """`bound` of kernel F on x: forward x read and y written (2 tensor-
    sizes), backward x and dy read and dx written (3); about 20 fp32
    operations an element forward, 30 backward (the exponential counted
    as a few)."""
    mem_rate, _, fp32_peak = peaks
    n = x.numel()
    return bound((3 if backward else 2) * n * x.element_size(),
                 (30.0 if backward else 20.0) * n, fp32_peak, mem_rate)


def quick_gelu_times(x, dy, flush, peaks):
    """Kernel F's two rows on x and the output gradient dy, by `time_ms`:
    forward (F, and the eager composition `quick_gelu_plain`: three
    kernels) and backward (F; eager autograd's five kernels from the
    graph it kept, sigmoid's output among it; and `quick_gelu_bwd_plain`,
    which recomputes the sigmoid), each with its byte bound and F's share
    of it."""
    from .ops import quick_gelu as qg
    xe = x.detach().requires_grad_()
    ye = qg.quick_gelu_plain(xe)
    rows = {}
    for key, fn, eager, plain in (
            ("forward", lambda: qg.quick_gelu_forward(x),
             lambda: qg.quick_gelu_plain(x), None),
            ("backward", lambda: qg.quick_gelu_backward(x, dy),
             lambda: torch.autograd.grad(ye, xe, dy, retain_graph=True),
             lambda: qg.quick_gelu_bwd_plain(x, dy))):
        b_ms, by = quick_gelu_bound(x, peaks, key == "backward")
        ms = time_ms(fn, flush)
        rows[key] = dict(ms=ms, eager_ms=time_ms(eager, flush),
                         plain_ms=None if plain is None
                         else time_ms(plain, flush),
                         bound_ms=b_ms, bound_by=by,
                         of_bound=round(100 * b_ms / ms, 1))
    return rows
