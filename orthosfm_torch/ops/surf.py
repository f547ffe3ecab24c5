"""SURF feature detection in PyTorch (64-d descriptors): port of
orthosfm_tpu/ops/surf.py.

Replacement for MVE's SURF (src/mve/sfm/surf.{h,cc}), part of the
reference's FEATURE_ALL default (matching_mve.cpp:333). Algorithm follows MVE:
integral-image box-filter Hessian responses with filter sizes 3·fs for
fs ∈ kernel_sizes[octave][sample] (surf.cc:28-34),
det(H) = Dxx·Dyy − 0.912·Dxy² (surf.cc:160-213), strict 3x3x3 non-maximum
suppression on the two middle samples (surf.cc:310-375), single-step 3x3x3
quadratic localization with |offset| ≤ 0.5 and contrast ≥ 500
(surf.cc:356-475), sliding-window Haar orientation (surf.cc:519-617) and the
4x4 × (Σdx, Σdy, Σ|dx|, Σ|dy|) descriptor with σ = 3.3s weighting
(surf.cc:663-733).

The summed-area table is exact integer arithmetic (int64 cumsums, held as
int32: exact for ≤ 8 MP byte images; the reference caps at 6 MP). Detection
runs on the (V, H, W) stack at a fixed capacity per octave; orientation and
descriptor run on the host-compacted valid keypoints only, gathering SAT
corners per Haar sample. That gives, for every in-bounds keypoint, the
values of the JAX package's per-scale Haar-map path bit for bit (same corner
arithmetic, same int32→f32 cast point).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orthosfm_torch.ops.sift import _interior, top_k_first

KERNEL_SIZES = np.array([
    [3, 5, 7, 9],
    [5, 9, 13, 17],
    [9, 17, 25, 33],
    [17, 33, 49, 65],
])
CONTRAST_THRESHOLD = 500.0
HESSIAN_WEIGHT = 0.912
N_OCTAVES = 4
ORI_DESC_CHUNK = 1024  # keypoints per orientation/descriptor step


class SurfFeatures(NamedTuple):
    """Metadata host numpy; desc a device tensor (see sift.Features)."""

    xy: np.ndarray  # (K, 2) input-image pixels
    scale: np.ndarray  # (K,)
    orientation: np.ndarray  # (K,)
    desc: torch.Tensor  # (K, 64) device
    valid: np.ndarray  # (K,)


def integral_image(gray01):
    """int32 SAT of the byte-scaled image over (..., H, W):
    S[y, x] = Σ_{j≤y, i≤x} img255."""
    img = torch.round(gray01 * 255.0).to(torch.int64)
    return torch.cumsum(torch.cumsum(img, dim=-1), dim=-2).to(torch.int32)


def _shift(S, dy, dx, step: int = 1):
    """S[..., y·step+dy, x·step+dx] over the strided output grid, zero-padded
    out of range (valid pixels are interior anyway)."""
    H, W = S.shape[-2:]
    oh = (H + step - 1) // step
    ow = (W + step - 1) // step
    pad = F.pad(S, (abs(dx), abs(dx) + step, abs(dy), abs(dy) + step))
    y0, x0 = abs(dy) + dy, abs(dx) + dx
    return pad[..., y0:y0 + (oh - 1) * step + 1:step, x0:x0 + (ow - 1) * step + 1:step]


def _response_map(S, fs: int, step: int):
    """det(H) response map at one (octave, sample) over (V, H, W) SATs:
    filter_dxx/dyy/dxy (surf.cc:218-305) as shifted-slice arithmetic."""
    fs2 = fs // 2
    H, W = S.shape[-2:]

    def at(dy, dx):
        return _shift(S, dy, dx, step)

    # filter_dxx: rows y−fs, y+fs−1; cols x−fs−fs2−1 + {0, fs, 2fs, 3fs}
    c0 = -fs - fs2 - 1
    v0, v1, v2, v3 = (at(-fs, c0 + k * fs) for k in range(4))
    r2 = fs - 1
    v4, v5, v6, v7 = (at(r2, c0 + k * fs) for k in range(4))
    dxx = (v5 + v0 - v4 - v1) - 2 * (v6 + v1 - v5 - v2) + (v7 + v2 - v6 - v3)

    # filter_dyy (transposed pattern)
    r0 = -fs - fs2 - 1
    w0, w1, w2, w3 = (at(r0 + k * fs, -fs) for k in range(4))
    cc = fs - 1
    w4, w5, w6, w7 = (at(r0 + k * fs, cc) for k in range(4))
    dyy = (w5 + w0 - w1 - w4) - 2 * (w6 + w1 - w2 - w5) + (w7 + w2 - w3 - w6)

    # filter_dxy: four signed fs×fs boxes around the center
    def box(y0, x0, y1, x1):
        return at(y1, x1) + at(y0, x0) - at(y0, x1) - at(y1, x0)

    a = -fs - 1
    dxy = (box(a, a, a + fs, a + fs) - box(a, 0, a + fs, fs)
           - box(0, a, fs, a + fs) + box(0, 0, fs, fs))

    inv_karea = 1.0 / (fs * (2 * fs - 1))
    dxx_t = dxx.to(torch.float32) * inv_karea
    dyy_t = dyy.to(torch.float32) * inv_karea
    dxy_t = dxy.to(torch.float32) * inv_karea
    resp = dxx_t * dyy_t - HESSIAN_WEIGHT * dxy_t * dxy_t

    # Zero the border (surf.cc:191-199); coordinates are full-res x = step·i
    border = fs + fs2 + 1
    yy = torch.arange(resp.shape[-2], device=S.device)[:, None] * step
    xx = torch.arange(resp.shape[-1], device=S.device)[None, :] * step
    ok = (xx >= border) & (xx + border < W) & (yy >= border) & (yy + border < H)
    return torch.where(ok, resp, 0.0)


def _octave_responses(S, o: int):
    step = 2**o
    return torch.stack([_response_map(S, int(KERNEL_SIZES[o][k]), step) for k in range(4)],
                       dim=1)


def _detect_octave(resp, cap: int):
    """Strict NMS over the two middle samples (surf.cc:310-343);
    resp (V, 4, h, w). Returns (s, y, x, valid), each (V, cap)."""
    V, _, h, w = resp.shape
    interior = _interior(h, w, resp.device)
    masks = []
    for s in (1, 2):
        center = resp[:, s]
        ok = torch.ones_like(center, dtype=torch.bool)
        for l in (s - 1, s, s + 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if l == s and dy == 0 and dx == 0:
                        continue
                    ok &= torch.roll(resp[:, l], (-dy, -dx), dims=(-2, -1)) < center
        masks.append(ok & interior)
    score = torch.where(torch.stack(masks, dim=1), resp[:, 1:3], -np.inf).reshape(V, -1)
    k = min(cap, score.shape[1])
    top, idx = top_k_first(score, k)
    if k < cap:
        top = F.pad(top, (0, cap - k), value=-np.inf)
        idx = F.pad(idx, (0, cap - k))
    valid = torch.isfinite(top) & (top > 0)
    rem = idx % (h * w)
    return idx // (h * w) + 1, rem // w, rem % w, valid


def _localize_octave(resp, s, y, x, valid, o: int):
    """Single-iteration 3x3x3 quadratic localization (surf.cc:356-475) over
    (V, K) keypoints: one gather per stencil tap and a closed-form cofactor
    solve."""
    V, S4, h, w = resp.shape
    iy = torch.clamp(y, 1, h - 2)
    ix = torch.clamp(x, 1, w - 2)
    flat = resp.reshape(V, -1)

    def at(ds, dy, dx):
        return torch.gather(flat, 1, ((s + ds) * h + iy + dy) * w + ix + dx)

    gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    gs = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    c0 = at(0, 0, 0)
    a = at(0, 0, -1) - 2 * c0 + at(0, 0, 1)   # xx
    e = at(0, -1, 0) - 2 * c0 + at(0, 1, 0)   # yy
    i = at(-1, 0, 0) - 2 * c0 + at(1, 0, 0)   # ss
    b = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))  # xy
    c = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))  # xs
    f = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))  # ys

    A11, A12, A13 = e * i - f * f, -(b * i - f * c), b * f - e * c
    A22, A23 = a * i - c * c, -(a * f - b * c)
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    singular = torch.abs(det) < 1e-5
    inv_det = torch.where(singular, 0.0, 1.0 / torch.where(singular, 1.0, det))
    # sol = A⁻¹·b_vec with b_vec = −g (reference vec_b, surf.cc:418-421)
    sx = -(A11 * gx + A12 * gy + A13 * gs) * inv_det
    sy = -(A12 * gx + A22 * gy + A23 * gs) * inv_det
    ss = -(A13 * gx + A23 * gy + A33 * gs) * inv_det
    off_ok = (torch.maximum(torch.maximum(torch.abs(sx), torch.abs(sy)),
                            torch.abs(ss)) <= 0.5) & ~singular
    # MVE: dog_value = N9[1][4] - 0.5 * vec_b.dot(vec_x) with vec_b = -g
    value = c0 - 0.5 * (-(gx * sx + gy * sy + gs * ss))
    contrast_ok = value >= CONTRAST_THRESHOLD
    sampling = 2.0**o
    fx = (ix.to(torch.float32) + sx) * sampling
    fy = (iy.to(torch.float32) + sy) * sampling
    fsamp = s.to(torch.float32) + ss
    return fx, fy, fsamp, valid & off_ok & contrast_ok


# Circular offsets of the orientation window (surf.cc:558-576)
_ORI_OFFSETS = np.array([(rx, ry) for ry in range(-5, 6) for rx in range(-5, 6)
                         if rx * rx + ry * ry < 36])
_ORI_GAUSS = np.exp(-(_ORI_OFFSETS[:, 0] ** 2 + _ORI_OFFSETS[:, 1] ** 2) / (2.0 * 2.5**2))
# Sliding-window centers, accumulated in f32 like numpy's (and jnp's) arange
_WINDOW_CENTERS = np.arange(-np.pi, np.pi, np.pi / 8.0, dtype=np.float32)


def _haar_dx_dy(S, vi, x, y, fs):
    """Haar wavelet responses (surf.cc:623-659) from clamped corners of the
    (V, H, W) SAT stack; vi, x, y, fs integer tensors of broadcastable shapes."""
    H, W = S.shape[-2:]

    def at(yy, xx):
        return S[vi, torch.clamp(yy, 0, H - 1), torch.clamp(xx, 0, W - 1)]

    x1, x2 = at(y - fs - 1, x - fs - 1), at(y - fs - 1, x - 1)
    x3, x4 = at(y - fs - 1, x), at(y - fs - 1, x + fs)
    x5, x6 = at(y + fs, x - fs - 1), at(y + fs, x - 1)
    x7, x8 = at(y + fs, x), at(y + fs, x + fs)
    y1, y2 = at(y - 1, x - fs - 1), at(y - 1, x + fs)
    y3, y4 = at(y, x - fs - 1), at(y, x + fs)
    norm = ((2 * fs + 1) * fs * (fs + 1)).to(torch.float32)
    dx = ((x8 + x2 - x4 - x6) - (x7 + x1 - x3 - x5)).to(torch.float32) / norm
    dy = ((x8 + y1 - x5 - y2) - (y4 + x1 - y3 - x4)).to(torch.float32) / norm
    return dx, dy


def _orientation_block(S, vi, kx, ky, scale):
    """Dominant orientation via π/3 sliding windows (surf.cc:519-617) over a
    flat (C,) keypoint block. Returns (orientation (C,), in_bounds (C,))."""
    H, W = S.shape[-2:]
    ix = torch.floor(kx + 0.5).to(torch.int64)[:, None]
    iy = torch.floor(ky + 0.5).to(torch.int64)[:, None]
    s = scale.to(torch.int64)[:, None]
    spacing = (8 * s + 1)[:, 0]
    in_bounds = ((ix[:, 0] >= spacing) & (iy[:, 0] >= spacing)
                 & (ix[:, 0] + spacing < W) & (iy[:, 0] + spacing < H))

    offs = torch.as_tensor(_ORI_OFFSETS, dtype=torch.int64, device=S.device)  # (109, 2)
    gauss = torch.as_tensor(_ORI_GAUSS, dtype=torch.float32, device=S.device)
    px = ix + offs[None, :, 0] * s  # (C, 109)
    py = iy + offs[None, :, 1] * s
    dx, dy = _haar_dx_dy(S, vi[:, None], px, py, 2 * s)
    dx = dx * gauss
    dy = dy * gauss
    ang = torch.atan2(dy, dx)  # (C, 109)

    centers = torch.as_tensor(_WINDOW_CENTERS, device=S.device)
    lo = centers - np.pi / 6.0  # (16,)
    hi = centers + np.pi / 6.0
    a = ang[:, :, None]
    inside = (((a > lo) & (a < hi))
              | ((a + 2 * np.pi > lo) & (a + 2 * np.pi < hi))
              | ((a - 2 * np.pi > lo) & (a - 2 * np.pi < hi)))  # (C, 109, 16)
    sx = torch.sum(torch.where(inside, dx[:, :, None], 0.0), dim=1)  # (C, 16)
    sy = torch.sum(torch.where(inside, dy[:, :, None], 0.0), dim=1)
    best = torch.argmax(sx * sx + sy * sy, dim=-1, keepdim=True)  # first maximum
    bsx = torch.gather(sx, 1, best)[:, 0]
    bsy = torch.gather(sy, 1, best)[:, 0]
    return torch.atan2(bsy, bsx), in_bounds


def _descriptor_block(S, vi, kx, ky, scale, ori):
    """64-d SURF descriptor (surf.cc:663-733) over a flat (C,) keypoint
    block. Returns (desc (C, 64), ok (C,))."""
    H, W = S.shape[-2:]
    C = kx.shape[0]
    s = scale.to(torch.int64)
    spacing = (15 * s + 1).to(torch.float32)
    in_bounds = ((kx >= spacing) & (ky >= spacing) & (kx + spacing < W) & (ky + spacing <= H))
    sino, coso = torch.sin(ori)[:, None, None], torch.cos(ori)[:, None, None]

    grid = torch.arange(-10, 10, device=S.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")  # (20, 20), x along columns
    gxf = (gx.to(torch.float32) + 0.5)[None]
    gyf = (gy.to(torch.float32) + 0.5)[None]
    sf = s.to(torch.float32)[:, None, None]
    rot_x = torch.floor(kx[:, None, None] + (coso * gxf - sino * gyf) * sf
                        + 0.5).to(torch.int64)  # (C, 20, 20)
    rot_y = torch.floor(ky[:, None, None] + (sino * gxf + coso * gyf) * sf
                        + 0.5).to(torch.int64)

    dx, dy = _haar_dx_dy(S, vi[:, None, None], rot_x, rot_y, s[:, None, None])
    odx = coso * dx + sino * dy
    ody = -sino * dx + coso * dy
    weight = torch.exp(-(gx.to(torch.float32) ** 2 + gy.to(torch.float32) ** 2)
                       / (2.0 * 3.3) ** 2)[None]
    stats = torch.stack([weight * odx, weight * ody,
                         weight * torch.abs(odx), weight * torch.abs(ody)], dim=-1)
    d = stats.reshape(C, 4, 5, 4, 5, 4).sum(dim=(2, 4)).reshape(C, 64)  # (C, yb, xb, 4)
    norm2 = torch.sum(d * d, dim=-1)
    nonzero = norm2 > 1e-8
    d = d / torch.sqrt(torch.clamp(norm2, min=1e-12))[:, None]
    return d, in_bounds & nonzero


def _octave_cap(per_octave_cap: int, h: int, w: int, o: int) -> int:
    """Per-octave keypoint capacity, shrunk with the octave's response sample
    count (NMS maxima get sparser as the stride grows)."""
    return max(128, min(per_octave_cap, (h * w) >> (2 * o + 6)))


def _detect_surf_batch(grays, per_octave_cap: int):
    """SAT + responses + NMS + localization for all octaves over a (V, H, W)
    stack. Returns (S (V, H, W) SAT stack, kp (V, ΣcapO, 4) packed
    [x, y, scale, valid])."""
    H, W = grays.shape[-2:]
    S = integral_image(grays)
    kps = []
    for o in range(N_OCTAVES):
        cap = _octave_cap(per_octave_cap, H, W, o)
        resp = _octave_responses(S, o)
        s_idx, yy, xx, valid = _detect_octave(resp, cap)
        fx, fy, fsamp, valid = _localize_octave(resp, s_idx, yy, xx, valid, o)
        del resp
        samp_round = torch.clamp(torch.floor(fsamp + 0.5).to(torch.int64), 0, 3)
        fs_tab = torch.as_tensor(KERNEL_SIZES[o], dtype=torch.float32, device=grays.device)
        scale = 3.0 * fs_tab[samp_round] * 1.2 / 9.0
        kps.append(torch.stack([fx, fy, scale, valid.to(torch.float32)], dim=-1))
    return S, torch.cat(kps, dim=1)


def extract_batch(grays, per_octave_cap: int = 1024) -> SurfFeatures:
    """Batched SURF over a (V, H, W) same-shape stack: metadata fields host
    numpy with a leading V axis, desc a (V, slots, 64) device tensor. Two
    host syncs: the keypoint pull and the orientation pull."""
    V, H, W = grays.shape
    S, kp_packed = _detect_surf_batch(grays, per_octave_cap)
    kp_np = kp_packed.cpu().numpy()  # sync 1
    n_slots = kp_np.shape[1]
    vi_np, ki_np = np.nonzero(kp_np[:, :, 3] > 0.5)
    kxyz = kp_np[vi_np, ki_np, :3]
    xy = np.zeros((V, n_slots, 2), np.float32)
    scale_out = np.zeros((V, n_slots), np.float32)
    ori_out = np.zeros((V, n_slots), np.float32)
    valid_out = np.zeros((V, n_slots), bool)
    desc_slots = torch.zeros((V, n_slots, 64), dtype=torch.float32, device=grays.device)
    if len(vi_np) == 0:
        return SurfFeatures(xy=xy, scale=scale_out, orientation=ori_out, desc=desc_slots,
                            valid=valid_out)

    kp = torch.as_tensor(kxyz, device=grays.device)
    vi = torch.as_tensor(vi_np, device=grays.device)
    oris, oks, descs = [], [], []
    for c in range(0, len(vi_np), ORI_DESC_CHUNK):
        sl = slice(c, c + ORI_DESC_CHUNK)
        kx, ky, sc = kp[sl, 0], kp[sl, 1], kp[sl, 2]
        ori, ok1 = _orientation_block(S, vi[sl], kx, ky, sc)
        d, ok2 = _descriptor_block(S, vi[sl], kx, ky, sc, ori)
        oris.append(ori)
        oks.append(ok1 & ok2)
        descs.append(torch.where((ok1 & ok2)[:, None], d, 0.0))
    desc_slots[vi, torch.as_tensor(ki_np, device=grays.device)] = torch.cat(descs)
    packed = torch.stack([torch.cat(oris), torch.cat(oks).to(torch.float32)], -1)
    packed_np = packed.cpu().numpy()  # sync 2
    ori_out[vi_np, ki_np] = packed_np[:, 0]
    valid_out[vi_np, ki_np] = packed_np[:, 1] > 0.5
    xy[vi_np, ki_np] = kxyz[:, :2]
    scale_out[vi_np, ki_np] = kxyz[:, 2]
    return SurfFeatures(xy=xy, scale=scale_out, orientation=ori_out, desc=desc_slots,
                        valid=valid_out)


def extract(gray01, per_octave_cap: int = 1024) -> SurfFeatures:
    """Single-image SURF: the V = 1 case of extract_batch (bit-identical).
    Fields as extract_batch's without the leading view axis."""
    fb = extract_batch(torch.as_tensor(gray01)[None], per_octave_cap)
    return SurfFeatures(*(f[0] for f in fb))
