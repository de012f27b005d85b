"""The particle kernels (CUDA) and their plain-PyTorch twins.

Counterpart of box2d_tpu/particles_pallas.py. Two kernels of
csrc/particles.cu run inside each particle sub-iteration:

- `window_pass` (K3, replaces `particles_pallas._kernel` / `window_pass`):
  for each cell-sorted particle, the sum over its live neighbours within
  one diameter of the weight, pressure or damping term. The JAX kernel
  works on 256-lane blocks against three 128-aligned bands of the sorted
  table (`build_tab`, `block_offsets`) and flags a block whose bands miss
  a neighbour cell; the port visits every lane of each particle's three
  neighbour key ranges, so it has no band layout and never truncates (its
  overflow count is always 0). The kernel stages each 256-lane block's
  union of ranges in shared memory when it fits (`k3_block_paths` says
  which blocks do).
- `window_pass_batched` (K3 batched, replaces `window_pass` as jax.vmap of
  the particle step traces it, with a batch axis on its grid and one
  scalar row a world): W worlds' tables in one launch; world w's result
  is what `window_pass` gives on world w's table. `k3_batched_plan`
  picks its kernel from a world's capacity: tables of at most
  K3_SMALL_LANES lanes take the small-world kernel (a group of threads
  for a world's lanes, three a lane, the world's whole table in shared
  memory), wider ones the grid kernel (window_pass's kernel, a world a
  row of the grid).
- `rank_pass` (K4, replaces `particles_pallas._rank_kernel` / `rank_pass`):
  the nearly-sorted rank repair, the new sorted position of every lane as
  a windowed rank over the previously sorted key table; with
  `rank_window` and `rank_offsets` (copied from the JAX module, int32
  arithmetic with the same clamps).

Each wrapper takes the twin for CPU tensors only. For CUDA tensors it
launches the kernel or raises; there is no fallback. The source file's
header says what bounds each kernel on the card and what its design does
about it.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from .cuda_build import HERE, nvcc_build, twin

B_BLK = 256
# the candidate records a K3 block stages in shared memory
# (csrc/particles.cu kStage)
K3_STAGE = 2048
PH_WEIGHT, PH_PRESSURE, PH_DAMPING = 0, 1, 2
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

# kernel launches made by the wrappers (the twins do not count)
K3_LAUNCHES = 0
K3_BATCHED_LAUNCHES = 0   # every batched launch, on either kernel
K3_SMALL_LAUNCHES = 0     # the batched launches on the small-world kernel
K4_LAUNCHES = 0

SOURCE = os.path.join(HERE, "csrc", "particles.cu")
_LIB = None
BUILD_SECONDS = None   # wall time of this process's nvcc build


def build() -> ctypes.CDLL:
    """Compile csrc/particles.cu for sm_90a into _build/ (once per process)
    and load it (cuda_build.py). Raises if nvcc fails."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    lib, log, BUILD_SECONDS = nvcc_build(SOURCE, "particles")
    lib.b2t_particle_window.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.b2t_particle_window.restype = ctypes.c_int
    lib.b2t_particle_window_batched.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.b2t_particle_window_batched.restype = ctypes.c_int
    lib.b2t_particle_window_small.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.b2t_particle_window_small.restype = ctypes.c_int
    lib.b2t_particle_window_small_shape.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.b2t_particle_window_small_shape.restype = ctypes.c_int
    lib.b2t_particle_rank.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.b2t_particle_rank.restype = ctypes.c_int
    lib.ptxas_log = log
    _LIB = lib
    return lib


def _check(name, dev, want):
    for t, shape, dtype in want:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# K3: the neighbour window pass
# ---------------------------------------------------------------------------

def window_pass(pos, skey, alive, p0, p1, scalars, phase: int,
                paths=None):
    """One pair pass over the cell-sorted table.

    pos (n, 2) f32, skey (n,) i32 ascending cell keys (INT32_MAX for dead
    lanes), alive (n,) bool, p0 / p1 (n,) f32 (pressure: p0 = the
    particle's pressure; damping: (p0, p1) = its velocity; weight: unused),
    scalars (8,) f32 [inv_diameter, diameter^2, lin_damping, quad_damping,
    vel_per_pressure, 0, 0, 0]. Returns (n, 2) f32: (weight, 0) for
    PH_WEIGHT, the velocity change for PH_PRESSURE and PH_DAMPING. Dead
    lanes get 0 and are nobody's neighbour. paths: None, or a (2,) int32
    tensor on the same device to which the 256-lane blocks that walked
    staged candidates (paths[0]) and global ones (paths[1]) are added
    (on the CPU, as k3_block_paths counts them)."""
    global K3_LAUNCHES
    n = skey.shape[0]
    dev = pos.device
    f32 = torch.float32
    _check("window_pass", dev, [
        (pos, (n, 2), f32), (skey, (n,), torch.int32),
        (alive, (n,), torch.bool), (p0, (n,), f32), (p1, (n,), f32),
        (scalars, (8,), f32)])
    if paths is not None:
        _check("window_pass", dev, [(paths, (2,), torch.int32)])
    if phase not in (PH_WEIGHT, PH_PRESSURE, PH_DAMPING):
        raise ValueError(f"window_pass: unknown phase {phase}")
    if dev.type == "cpu":
        if paths is not None:
            paths += torch.tensor(k3_block_paths(skey, alive),
                                  dtype=torch.int32)
        return window_pass_reference(pos, skey, alive, p0, p1, scalars,
                                     phase)
    if dev.type != "cuda":
        raise ValueError(f"window_pass: unsupported device {dev}")
    lib = build()
    out = torch.empty((n, 2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.b2t_particle_window(
            pos.data_ptr(), skey.data_ptr(), alive.data_ptr(),
            p0.data_ptr(), p1.data_ptr(), scalars.data_ptr(),
            out.data_ptr(), 0 if paths is None else paths.data_ptr(), n,
            phase, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_pass kernel launch failed: cudaError {rc}")
    if n > 0:
        K3_LAUNCHES += 1
    return out


# K3 batched on small worlds: the small-world kernel (csrc/particles.cu,
# window_small_kernel) and the figures its plan is reckoned with.
# the widest table it takes: at 64 worlds it is 19% faster than the grid
# kernel at 1,024 lanes, level at 1,296 and 1-4% slower at 1,600
# (time_solver.py --k3-paths, NVIDIA H100 80GB HBM3, 700.00 W)
K3_SMALL_LANES = 1280
K3_GROUP_LANES = 256     # kSmallLanes: a group's most lanes, 3 threads each


class K3BatchedPlan(NamedTuple):
    path: str                # "small" or "grid"
    n: int                   # lanes of a world's table
    lanes: int               # a group's lanes (0 on the grid path)
    groups_per_cta: int      # (0 on the grid path)


@functools.lru_cache(maxsize=None)
def k3_batched_plan(n: int, path: str | None = None) -> K3BatchedPlan:
    """The kernel of a batched K3 launch on tables of n lanes a world,
    decided from n alone (no device read), once for each n: the
    small-world kernel up to K3_SMALL_LANES lanes, else the grid kernel;
    `path` forces one ("small" or "grid"). On the small kernel a group
    of 3 x lanes threads (three a lane, one for each neighbour row)
    takes `lanes` lanes of one world, n rounded up to a warp and at most
    K3_GROUP_LANES; a wider world takes ceil(n / lanes) groups, each with
    the world's whole table in its CTA's shared memory; narrower worlds
    share a CTA, groups_per_cta of them, up to K3_GROUP_LANES lanes. The
    kernel counts a CTA's shared memory itself (k3_small_shape) and
    refuses a table that does not fit (about 11,000 lanes)."""
    if path is None:
        path = "small" if n <= K3_SMALL_LANES else "grid"
    if path == "grid":
        return K3BatchedPlan("grid", n, 0, 0)
    if path != "small":
        raise ValueError(f"k3_batched_plan: unknown path {path!r}")
    lanes = min(K3_GROUP_LANES, max(32, -(-n // 32) * 32))
    return K3BatchedPlan("small", n, lanes, max(1, K3_GROUP_LANES // lanes))


def k3_small_shape(plan: K3BatchedPlan, phase: int) -> dict:
    """How the small-world kernel of `phase` runs at `plan`'s shape, as the
    card reports it: shared memory a CTA (bytes), CTAs an SM holds at
    once (0 where the shared memory is more than a CTA can have: the
    kernel refuses it), registers and local (spill) bytes a thread. Needs
    a CUDA device."""
    out = (ctypes.c_int * 4)()
    rc = build().b2t_particle_window_small_shape(
        plan.n, plan.lanes, plan.groups_per_cta, phase, out)
    if rc != 0:
        raise RuntimeError(f"k3_small_shape: cudaError {rc}")
    return dict(smem_per_cta=out[0], ctas_per_sm=out[1], registers=out[2],
                local_bytes=out[3])


def window_pass_batched(pos, skey, alive, p0, p1, scalars, phase: int,
                        paths=None, plan: K3BatchedPlan | None = None):
    """window_pass over W worlds' tables in one launch: pos (W, n, 2) f32,
    skey (W, n) i32 (each world's row ascending), alive (W, n) bool, p0 /
    p1 (W, n) f32, scalars (W, 8) f32, one row a world. Returns (W, n, 2)
    f32; world w's rows are what window_pass returns for world w's table
    and scalar row, and no particle sees another world's neighbour.
    plan: the kernel, k3_batched_plan(n) unless given. paths counts the
    grid kernel's 256-lane blocks of all worlds by path (as window_pass's
    does): given without a plan, the launch takes the grid kernel."""
    global K3_BATCHED_LAUNCHES, K3_SMALL_LAUNCHES
    n_w, n = skey.shape
    dev = pos.device
    f32 = torch.float32
    _check("window_pass_batched", dev, [
        (pos, (n_w, n, 2), f32), (skey, (n_w, n), torch.int32),
        (alive, (n_w, n), torch.bool), (p0, (n_w, n), f32),
        (p1, (n_w, n), f32), (scalars, (n_w, 8), f32)])
    if phase not in (PH_WEIGHT, PH_PRESSURE, PH_DAMPING):
        raise ValueError(f"window_pass_batched: unknown phase {phase}")
    plan = plan or k3_batched_plan(n, None if paths is None else "grid")
    if plan.n != n:
        raise ValueError(f"window_pass_batched: a plan for {plan.n} lanes "
                         f"on tables of {n}")
    if paths is not None:
        if plan.path != "grid":
            raise ValueError("window_pass_batched: paths counts the grid "
                             "kernel's blocks")
        _check("window_pass_batched", dev, [(paths, (2,), torch.int32)])
    if n_w > 65535:
        raise ValueError(f"window_pass_batched: {n_w} worlds (at most "
                         f"65535, the grid kernel's y)")
    if dev.type == "cpu":
        if paths is not None:
            paths += torch.tensor(k3_block_paths(skey, alive),
                                  dtype=torch.int32)
        return window_pass_batched_reference(pos, skey, alive, p0, p1,
                                             scalars, phase)
    if dev.type != "cuda":
        raise ValueError(f"window_pass_batched: unsupported device {dev}")
    lib = build()
    out = torch.empty((n_w, n, 2), dtype=f32, device=dev)
    ptrs = (pos.data_ptr(), skey.data_ptr(), alive.data_ptr(),
            p0.data_ptr(), p1.data_ptr(), scalars.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        if plan.path == "small":
            rc = lib.b2t_particle_window_small(
                *ptrs, n, n_w, plan.lanes, plan.groups_per_cta, phase,
                _stream(dev))
        else:
            rc = lib.b2t_particle_window_batched(
                *ptrs, 0 if paths is None else paths.data_ptr(), n, n_w,
                phase, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_pass_batched kernel launch failed "
                           f"({plan.path} kernel): cudaError {rc}")
    if n > 0 and n_w > 0:
        K3_BATCHED_LAUNCHES += 1
        K3_SMALL_LAUNCHES += plan.path == "small"
    return out


def neighbour_ranges(skey, alive):
    """For each sorted lane and each row offset d of (0, +1, -1): the lane
    range [start, end) of the sorted table holding the cells
    (row + d, col - 1) .. (row + d, col + 1). Targets are formed in int64
    and clamped to int32, as particles_pallas.block_offsets clamps them;
    a row outside the 16-bit range, or a dead lane, gets an empty range.
    skey and alive are one table (n,) or W tables (W, n), each searched
    alone. Returns a list of three (start, end) int64 pairs."""
    row = (skey >> 16).to(torch.int64)
    col = (skey & 0xFFFF).to(torch.int64)
    lo_c = torch.clamp(col - 1, min=0)
    hi_c = torch.clamp(col + 1, max=0xFFFF)
    out = []
    for d in (0, 1, -1):
        r = row + d
        ok = alive & (r >= -32768) & (r <= 32767)
        lo = torch.clamp(r * 65536 + lo_c, INT32_MIN, INT32_MAX)
        hi = torch.clamp(r * 65536 + hi_c, INT32_MIN, INT32_MAX)
        start = torch.searchsorted(skey, lo.to(torch.int32))
        end = torch.searchsorted(skey, hi.to(torch.int32), right=True)
        out.append((start, torch.where(ok, end, start)))
    return out


def k3_block_paths(skey, alive):
    """(staged, global): how many 256-lane blocks of the K3 kernel stage
    their candidates in shared memory and how many walk them in global
    memory, by the kernel's rule: a block stages when its three unions of
    neighbour ranges (one lane range per row offset, from the least lower
    key to the largest upper key of its lanes) hold at most K3_STAGE lanes
    together. skey and alive are one table (n,) or W tables (W, n), whose
    blocks are counted together."""
    n = skey.shape[-1]
    nbk = -(-n // B_BLK)
    skey, alive = skey.reshape(-1, n), alive.reshape(-1, n)
    total = torch.zeros((skey.shape[0], nbk), dtype=torch.int64,
                        device=skey.device)
    blocks = lambda x: torch.nn.functional.pad(
        x, (0, nbk * B_BLK - n)).view(x.shape[0], nbk, B_BLK)
    row = (skey >> 16).to(torch.int64)
    for d, (start, end) in zip((0, 1, -1), neighbour_ranges(skey, alive)):
        # the lanes that search row + d (an empty range counts too)
        has = blocks(alive & (row + d >= -32768) & (row + d <= 32767))
        lo = torch.where(has, blocks(start), n).min(dim=2).values
        hi = torch.where(has, blocks(end), -1).max(dim=2).values
        total += torch.where(has.any(dim=2), hi - lo, 0)
    staged = int((total <= K3_STAGE).sum())
    return staged, total.numel() - staged


def window_pass_reference(pos, skey, alive, p0, p1, scalars, phase: int):
    """The kernel's function in plain PyTorch: the same ranges
    (torch.searchsorted), the candidates of each range visited in lane
    order (padded to the widest range and masked), the same arithmetic in
    the same order, so it sums exactly as the kernel does. It is the
    one-world case of window_pass_batched_reference."""
    return window_pass_batched_reference(
        pos[None], skey[None], alive[None], p0[None], p1[None],
        scalars[None], phase)[0]


@twin
def window_pass_batched_reference(pos, skey, alive, p0, p1, scalars,
                                  phase: int):
    """window_pass_batched in plain PyTorch: W tables (W, n), each with its
    scalar row, their ranges searched in their own table. The terms of
    every candidate of a range (up to the widest range of any world,
    masked past each lane's own) are computed at once, then added to each
    lane's sum in lane order, one candidate after the other: the kernel's
    operations and order. A world whose ranges are narrower adds masked
    zeros past its own widest, which leave its sums as they are (a
    running sum that starts at +0 never holds -0), so world w equals the
    one-world twin on world w bit for bit."""
    n_w, n = skey.shape
    dev = pos.device
    inv_d, d2max, lin_d, quad_d, vel_per_p = (scalars[:, k, None, None]
                                              for k in range(5))
    lane = torch.arange(n, device=dev)[:, None]
    # one row a lane of every world: (x, y, p0, p1) and alive
    table = torch.stack([pos[..., 0], pos[..., 1], p0, p1],
                        dim=-1).reshape(n_w * n, 4)
    alive_all = alive.reshape(-1)
    base = (torch.arange(n_w, device=dev) * n)[:, None, None]
    px, py = pos[..., 0, None], pos[..., 1, None]
    my0, my1 = p0[..., None], p1[..., None]
    zero = torch.zeros((n_w, n), dtype=torch.float32, device=dev)
    ox, oy = zero, zero
    for start, end in neighbour_ranges(skey, alive):
        width = int((end - start).max()) if n else 0
        sx, sy = zero, zero
        if width > 0:
            j = start[..., None] + torch.arange(width, device=dev)
            jc = torch.clamp(j, max=n - 1)
            at = (jc + base).reshape(-1)
            c = table[at].reshape(n_w, n, width, 4)
            dx = c[..., 0] - px
            dy = c[..., 1] - py
            d2 = dx * dx + dy * dy
            valid = ((j < end[..., None]) & (jc != lane)
                     & alive_all[at].reshape(n_w, n, width) & (d2 < d2max))
            invdist = torch.where(
                d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)
            w = 1.0 - d2 * invdist * inv_d
            if phase == PH_WEIGHT:
                tx, ty = torch.where(valid, w, 0.0), None
            else:
                nx = dx * invdist
                ny = dy * invdist
                if phase == PH_PRESSURE:
                    fh = vel_per_p * w * (my0 + c[..., 2])
                    fx, fy = fh * nx, fh * ny
                else:
                    vn = (c[..., 2] - my0) * nx + (c[..., 3] - my1) * ny
                    valid = valid & (vn < 0)
                    damp = torch.maximum(lin_d * w,
                                         torch.clamp(-quad_d * vn, max=0.5))
                    f = damp * vn
                    fx, fy = f * nx, f * ny
                tx = torch.where(valid, fx, 0.0)
                ty = torch.where(valid, fy, 0.0)
            for k in range(width):
                sx = sx + tx[..., k]
                if ty is not None:
                    sy = sy + ty[..., k]
        if phase == PH_PRESSURE:
            ox, oy = ox + -sx, oy + -sy
        else:
            ox, oy = ox + sx, oy + sy
    return torch.stack([ox, oy], dim=-1)


# ---------------------------------------------------------------------------
# K4: the nearly-sorted rank repair
# ---------------------------------------------------------------------------

def rank_window(n: int) -> int:
    """Static rank-window size: ~5 cell rows of the sorted table plus block
    and alignment slack, clamped to [1536, 4096] lanes (128-multiples);
    particles_pallas.rank_window."""
    return min(4096, max(1536, (n // 24 + 127) // 128 * 128))


def rank_offsets(skey_prev, n_blocks: int, rb: int):
    """Per-block rank-window offsets over the previously sorted key table
    (particles_pallas.rank_offsets). Returns (offs (n_blocks,) int32,
    ok (n_blocks,) bool); ok[b] is False when block b's required coverage
    [first lane of old row r0 - 2, first lane of old row r1 + 3) does not
    fit in rb lanes from its 128-aligned offset: the caller then takes the
    full sort."""
    n = skey_prev.shape[0]
    dev = skey_prev.device
    n_pad = n_blocks * B_BLK + rb
    idx0 = torch.arange(n_blocks, dtype=torch.int64, device=dev) * B_BLK
    idx1 = torch.clamp(idx0 + B_BLK - 1, max=n - 1)
    fk = skey_prev[torch.clamp(idx0, max=n - 1)].to(torch.int64)
    lk = skey_prev[idx1].to(torch.int64)
    # row starts; +-2 / +3 rows can leave int32 (the row bias lives in the
    # sign bit): clamp, as the JAX code's wrap checks do
    row_lo = fk & ~0xFFFF
    row_hi = lk & ~0xFFFF
    tgt_lo = torch.clamp(row_lo - 2 * (1 << 16), min=INT32_MIN)
    tgt_hi = torch.clamp(row_hi + 3 * (1 << 16), max=INT32_MAX)
    lo_i = torch.searchsorted(skey_prev, tgt_lo.to(torch.int32))
    hi_i = torch.searchsorted(skey_prev, tgt_hi.to(torch.int32))
    start = torch.minimum(lo_i, idx0)
    off = torch.clamp(start - start % 128, 0, n_pad - rb)
    end_needed = torch.maximum(hi_i, idx1 + 1)
    ok = end_needed <= off + rb
    return off.to(torch.int32), ok


def rank_pass(newkey, offs, rb: int):
    """New sorted position of every lane. newkey (n,) i32: the cell keys in
    the current (previously sorted) lane order; offs (ceil(n / 256),) i32
    from rank_offsets. Returns (n,) i32 ranks: the inverse permutation of
    the stable argsort of newkey when rank_offsets' ok holds for every
    block and no key moved by more than one row and one column."""
    global K4_LAUNCHES
    n = newkey.shape[0]
    dev = newkey.device
    n_blocks = -(-n // B_BLK)
    _check("rank_pass", dev, [(newkey, (n,), torch.int32),
                              (offs, (n_blocks,), torch.int32)])
    if not 0 < rb <= 12288:
        raise ValueError(f"rank_pass: window of {rb} lanes")
    if dev.type == "cpu":
        return rank_pass_reference(newkey, offs, rb)
    if dev.type != "cuda":
        raise ValueError(f"rank_pass: unsupported device {dev}")
    lib = build()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.b2t_particle_rank(newkey.data_ptr(), offs.data_ptr(),
                                   out.data_ptr(), n, rb, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rank_pass kernel launch failed: cudaError {rc}")
    if n > 0:
        K4_LAUNCHES += 1
    return out


@twin
def rank_pass_reference(newkey, offs, rb: int, blocks_per_chunk: int = 8):
    """The kernel's windowed count in plain PyTorch, a few blocks at a time
    so that the (blocks, 256, rb) compare stays bounded."""
    n = newkey.shape[0]
    dev = newkey.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.arange(rb, device=dev)
    lanes = torch.arange(B_BLK, device=dev)
    n_blocks = offs.shape[0]
    for b0 in range(0, n_blocks, blocks_per_chunk):
        blocks = torch.arange(b0, min(b0 + blocks_per_chunk, n_blocks),
                              device=dev)
        off = offs[blocks].to(torch.int64)
        g = off[:, None] + t[None, :]                      # (nb, rb)
        wkey = torch.where(g < n, newkey[torch.clamp(g, max=n - 1)],
                           INT32_MAX)
        i = blocks[:, None] * B_BLK + lanes[None, :]       # (nb, 256)
        ki = newkey[torch.clamp(i, max=n - 1)]
        less = ((wkey[:, None, :] < ki[:, :, None])
                | ((wkey[:, None, :] == ki[:, :, None])
                   & (g[:, None, :] < i[:, :, None])))
        r = off[:, None] + less.sum(dim=2)
        live = i < n
        out[i[live]] = r[live].to(torch.int32)
    return out
