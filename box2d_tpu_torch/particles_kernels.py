"""The particle kernels (CUDA) and their plain-PyTorch twins.

Counterpart of box2d_tpu/particles_pallas.py. Two kernels of
csrc/particles.cu run inside each particle sub-iteration:

- `window_pass` (K3, replaces `particles_pallas._kernel` / `window_pass`):
  for each cell-sorted particle, the sum over its live neighbours within
  one diameter of the weight, pressure or damping term. The JAX kernel
  works on 256-lane blocks against three 128-aligned bands of the sorted
  table (`build_tab`, `block_offsets`) and flags a block whose bands miss
  a neighbour cell; the port finds each particle's three neighbour key
  ranges by binary search and visits every neighbour, so it has no band
  layout and never truncates (its overflow count is always 0).
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
import os

import torch

from .cuda_build import HERE, nvcc_build

B_BLK = 256
PH_WEIGHT, PH_PRESSURE, PH_DAMPING = 0, 1, 2
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

# kernel launches made by the wrappers (the twins do not count)
K3_LAUNCHES = 0
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
    lib.b2t_particle_window.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.b2t_particle_window.restype = ctypes.c_int
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

def window_pass(pos, skey, alive, p0, p1, scalars, phase: int):
    """One pair pass over the cell-sorted table.

    pos (n, 2) f32, skey (n,) i32 ascending cell keys (INT32_MAX for dead
    lanes), alive (n,) bool, p0 / p1 (n,) f32 (pressure: p0 = the
    particle's pressure; damping: (p0, p1) = its velocity; weight: unused),
    scalars (8,) f32 [inv_diameter, diameter^2, lin_damping, quad_damping,
    vel_per_pressure, 0, 0, 0]. Returns (n, 2) f32: (weight, 0) for
    PH_WEIGHT, the velocity change for PH_PRESSURE and PH_DAMPING. Dead
    lanes get 0 and are nobody's neighbour."""
    global K3_LAUNCHES
    n = skey.shape[0]
    dev = pos.device
    f32 = torch.float32
    _check("window_pass", dev, [
        (pos, (n, 2), f32), (skey, (n,), torch.int32),
        (alive, (n,), torch.bool), (p0, (n,), f32), (p1, (n,), f32),
        (scalars, (8,), f32)])
    if phase not in (PH_WEIGHT, PH_PRESSURE, PH_DAMPING):
        raise ValueError(f"window_pass: unknown phase {phase}")
    if dev.type == "cpu":
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
            out.data_ptr(), n, phase, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_pass kernel launch failed: cudaError {rc}")
    if n > 0:
        K3_LAUNCHES += 1
    return out


def neighbour_ranges(skey, alive):
    """For each sorted lane and each row offset d of (0, +1, -1): the lane
    range [start, end) of the sorted table holding the cells
    (row + d, col - 1) .. (row + d, col + 1). Targets are formed in int64
    and clamped to int32, as particles_pallas.block_offsets clamps them;
    a row outside the 16-bit range, or a dead lane, gets an empty range.
    Returns a list of three (start, end) int64 pairs."""
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


def window_pass_reference(pos, skey, alive, p0, p1, scalars, phase: int):
    """The kernel's function in plain PyTorch: the same ranges
    (torch.searchsorted), the candidates of each range visited in lane
    order (padded to the widest range and masked), the same arithmetic in
    the same order, so it sums exactly as the kernel does."""
    n = skey.shape[0]
    inv_d, d2max, lin_d, quad_d, vel_per_p = (scalars[k] for k in range(5))
    lane = torch.arange(n, device=pos.device)
    px, py = pos[:, 0], pos[:, 1]
    zero = torch.zeros(n, dtype=torch.float32, device=pos.device)
    ox, oy = zero, zero
    for start, end in neighbour_ranges(skey, alive):
        width = int((end - start).max()) if n else 0
        sx, sy = zero, zero
        for k in range(width):
            j = start + k
            jc = torch.clamp(j, max=n - 1)
            dx = px[jc] - px
            dy = py[jc] - py
            d2 = dx * dx + dy * dy
            valid = (j < end) & (jc != lane) & alive[jc] & (d2 < d2max)
            invdist = torch.where(
                d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)
            w = 1.0 - d2 * invdist * inv_d
            if phase == PH_WEIGHT:
                sx = sx + torch.where(valid, w, 0.0)
                continue
            nx = dx * invdist
            ny = dy * invdist
            if phase == PH_PRESSURE:
                fh = vel_per_p * w * (p0 + p0[jc])
                fx, fy = fh * nx, fh * ny
            else:
                vn = (p0[jc] - p0) * nx + (p1[jc] - p1) * ny
                valid = valid & (vn < 0)
                damp = torch.maximum(lin_d * w,
                                     torch.clamp(-quad_d * vn, max=0.5))
                f = damp * vn
                fx, fy = f * nx, f * ny
            sx = sx + torch.where(valid, fx, 0.0)
            sy = sy + torch.where(valid, fy, 0.0)
        if phase == PH_PRESSURE:
            ox, oy = ox + -sx, oy + -sy
        else:
            ox, oy = ox + sx, oy + sy
    return torch.stack([ox, oy], dim=1)


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
