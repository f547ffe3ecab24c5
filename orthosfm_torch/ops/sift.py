"""SIFT feature detection in PyTorch: port of orthosfm_tpu/ops/sift.py.

Algorithm and every threshold follow the MVE implementation (the reference's
matching engine): Gaussian scale space with S+3 images per octave
(sift.cc:212-261), strict 26-neighbour DoG extrema (sift.cc:284-331), 5-step
Taylor localization with contrast/edge/offset filters (sift.cc:339-484),
36-bin orientation histograms smoothed 6x with 80%-peak multi-orientation
(sift.cc:598-667), and 4x4x8 trilinear descriptors with 0.2 clamping
(sift.cc:669-843).

Layout, as in the JAX package: the detection stages run on a (V, H, W) view
stack at a fixed keypoint capacity per octave; the valid keypoints of every
view are then compacted on the host into one flat array, and the
orientation/descriptor stages run on that array only, in chunks. The
trilinear descriptor scatter-add is the hat-weight factorization
desc[by, bx, bt] = Σ_px Wy·Wx·(Wt·contrib), one batched matrix product per
chunk and orientation.

Numerics kept from the JAX package, because thresholds turn 1-ulp
differences into different keypoints: blurs are tap-weighted shifted adds in
the same order (not a convolution), and the capped top-k selections rank
like lax.top_k (larger value first, lower index first among equal values).
Host syncs: one pull of every octave's keypoints, then one pull of every
octave's orientations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from orthosfm_torch.utils.profiling import stage

# MVE defaults (sift.h:48-90, sift.cc:226-236)
SAMPLES = 3  # num_samples_per_octave
BASE_BLUR = 1.6
INHERENT_BLUR = 0.5
MAX_OCTAVE = 4
CONTRAST_THRESHOLD = 0.02 / SAMPLES
EDGE_RATIO = 10.0
N_ORI_BINS = 36
MAX_ORIENTATIONS = 4  # peaks kept per keypoint
ORI_PATCH = 37  # covers win = int(4.5 * sigma_max) = 18
DESC_PATCH = 85  # covers win = int(sqrt(2) * 3 * sigma_max * 2.5) = 42
ORI_DESC_CHUNK = 1024  # keypoints per orientation/descriptor step

K_FACTOR = 2.0 ** (1.0 / SAMPLES)
TWO_PI = 2.0 * math.pi


def _odd(n: int) -> int:
    return n if n % 2 == 1 else n - 1


class Features(NamedTuple):
    """Features in input-image pixel coordinates. Metadata fields are host
    numpy; desc is a device tensor. extract_batch gives every field a leading
    view axis."""

    xy: np.ndarray  # (K, 2)
    scale: np.ndarray  # (K,) absolute scale
    orientation: np.ndarray  # (K,)
    desc: torch.Tensor  # (K, 128) device
    valid: np.ndarray  # (K,)


# ---------------------------------------------------------------------------
# Ranking like lax.top_k


def top_k_first(score, k: int):
    """(values, indices) of the k largest entries of the last axis of a
    float score whose wanted entries are > 0, ranked like lax.top_k: larger
    first, lower index first among equal values. Entries ≤ 0 rank last, in
    no promised order (callers treat them as invalid).

    torch.topk promises no order among equal values, so the rank key packs
    the f32 bits of max(score, 0) (monotone for non-negative floats) above
    the complement of the index into one int64, and every key is unique."""
    n = score.shape[-1]
    bits = torch.clamp(score, min=0.0).contiguous().view(torch.int32).to(torch.int64)
    rev = (1 << 32) - 1 - torch.arange(n, dtype=torch.int64, device=score.device)
    top = torch.topk(bits * (1 << 32) + rev, k, dim=-1).values
    idx = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    vals = torch.gather(score, -1, idx)
    return vals, idx


def _top_k_small(score, k: int):
    """lax.top_k over a short last axis (orientation bins): a stable
    descending sort keeps the lower index first among equal values."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Image pyramid


def grayscale(rgb):
    """uint8 RGB -> float gray via channel average (MVE DESATURATE_AVERAGE)."""
    return torch.mean(rgb.to(torch.float32), dim=-1) / 255.0


def _gauss_kernel_np(sigma: float) -> np.ndarray:
    # MVE blur_gaussian kernel radius: ceil(sigma * 2.884) (image_tools.h)
    r = max(int(math.ceil(sigma * 2.884)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def edge_pad(x, before: int, after: int, dim: int):
    """Edge-replicate padding of one axis (any rank) by index clamping."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-before, n + after, device=x.device), 0, n - 1)
    return torch.index_select(x, dim, idx)


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur with edge-replicate padding over (..., H, W),
    as tap-weighted shifted adds in the JAX package's order."""
    k = _gauss_kernel_np(sigma)
    r = (len(k) - 1) // 2
    H, W = img.shape[-2], img.shape[-1]
    p = edge_pad(img, r, r, -2)
    img = sum(float(k[i]) * p[..., i:i + H, :] for i in range(len(k)))
    p = edge_pad(img, r, r, -1)
    return sum(float(k[i]) * p[..., i:i + W] for i in range(len(k)))


def _fma(k: float, x, acc):
    """f32 k·x + acc with one multiply-add: the f32 product is exact in f64,
    so forming the sum there and rounding to f32 gives the fused result."""
    return (float(np.float32(k)) * x.double() + acc.double()).to(torch.float32)


def half_size_gaussian(img):
    """Gaussian-weighted 2x downsample, σ=0.866 over the 4x4 support
    (MVE rescale_half_size_gaussian, image_tools.h:619-693); (..., H, W).

    The 16 taps are summed in the JAX package's order, with each add fused
    into the multiply before it, as the JAX package's jitted program does
    (XLA contracts mul + add into an FMA; the first add fuses its left
    product): the gray images of views above max_image_pixels then agree
    bit for bit."""
    sigma = 0.866025403784439
    w1 = math.exp(-0.5 / (2.0 * sigma**2))
    w2 = math.exp(-2.5 / (2.0 * sigma**2))
    w3 = math.exp(-4.5 / (2.0 * sigma**2))
    kernel = np.array(
        [[w3, w2, w2, w3], [w2, w1, w1, w2], [w2, w1, w1, w2], [w3, w2, w2, w3]],
        np.float64,
    )
    kernel /= kernel.sum()
    H, W = img.shape[-2], img.shape[-1]
    ho, wo = (H + 1) // 2, (W + 1) // 2
    # Output (x,y) reads input rows/cols (2y-1 .. 2y+2) with edge clamping
    p = edge_pad(edge_pad(img, 1, 2, -2), 1, 2, -1)
    taps = [(float(kernel[i, j]), p[..., i:i + 2 * ho - 1:2, j:j + 2 * wo - 1:2])
            for i in range(4) for j in range(4)]
    (k0, x0), (k1, x1) = taps[:2]
    out = _fma(k0, x0, float(np.float32(k1)) * x1)
    for k, x in taps[2:]:
        out = _fma(k, x, out)
    return out


def build_octave(base, has_sigma: float):
    """(V, S+3) blurred images + (V, S+2) DoGs for one octave
    (sift.cc:212-261); base (V, H, W)."""
    target = BASE_BLUR
    if target > has_sigma:
        base = gaussian_blur(base, math.sqrt(target**2 - has_sigma**2))
    imgs = [base]
    sigma = target
    dogs = []
    for _ in range(1, SAMPLES + 3):
        sigmak = sigma * K_FACTOR
        blur = math.sqrt(sigmak**2 - sigma**2)
        nxt = gaussian_blur(imgs[-1], blur)
        imgs.append(nxt)
        dogs.append(nxt - imgs[-2])
        sigma = sigmak
    return torch.stack(imgs, dim=1), torch.stack(dogs, dim=1)


# ---------------------------------------------------------------------------
# Extrema detection + localization (per octave, batched over views)


def _interior(h: int, w: int, device):
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def _neighborhood_max_min(dogs):
    """For every DoG triplet (s, s+1, s+2): strict 26-neighbour extremum mask
    of the middle image (sift.cc:284-331). dogs: (V, S+2, H, W) →
    (V, S, H, W) bool (borders excluded)."""
    S2, H, W = dogs.shape[-3:]
    border = _interior(H, W, dogs.device)
    masks = []
    for s in range(S2 - 2):
        center = dogs[:, s + 1]
        larger = torch.ones_like(center, dtype=torch.bool)
        smaller = torch.ones_like(center, dtype=torch.bool)
        for l in range(3):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if l == 1 and dy == 0 and dx == 0:
                        continue
                    n = torch.roll(dogs[:, s + l], (-dy, -dx), dims=(-2, -1))
                    larger &= n < center
                    smaller &= n > center
        masks.append((larger | smaller) & border)
    return torch.stack(masks, dim=1)


def detect_extrema(dogs, cap: int):
    """Top-`cap` extrema by |DoG| response per view. Returns (s, y, x, valid),
    each (V, cap)."""
    masks = _neighborhood_max_min(dogs)  # (V, S, H, W)
    V, S, H, W = masks.shape
    vals = torch.abs(dogs[:, 1:1 + S])  # center image of each triplet
    score = torch.where(masks, vals, -1.0).reshape(V, -1)
    k = min(cap, score.shape[1])
    top, idx = top_k_first(score, k)
    if k < cap:  # tiny octave: pad result slots up to the capacity
        top = torch.nn.functional.pad(top, (0, cap - k), value=-1.0)
        idx = torch.nn.functional.pad(idx, (0, cap - k))
    valid = top > 0.0
    s = idx // (H * W)
    rem = idx % (H * W)
    return s, rem // W, rem % W, valid


def localize_keypoints(dogs, s, y, x, valid):
    """Taylor localization with up to 5 re-centering iterations + stability
    filters (sift.cc:339-484). dogs (V, S+2, H, W); s, y, x, valid (V, K).
    Returns refined (x, y, sample, valid), each (V, K).

    Each iteration gathers the 3x3x3 DoG cube around every keypoint and
    solves the Taylor system in closed form (cofactor 3x3)."""
    V, S2, H, W = dogs.shape
    K = s.shape[1]
    dflat = dogs.reshape(V, -1)
    # Flat offsets of the 27-cube around (s, y, x), ds/dy/dx-major
    offs = torch.tensor([(ds * H + dy) * W + dx
                         for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dtype=torch.int64, device=dogs.device)

    def deriv_at(ix, iy, s0):
        """(10, V, K) Taylor derivatives from gathered 27-cubes. The keypoint
        coordinates are clamped to [1, dim−2], so every entry is in bounds."""
        base = (s0 * H + iy) * W + ix  # (V, K)
        C = torch.gather(dflat, 1, (base[:, :, None] + offs).reshape(V, -1))
        C = C.reshape(V, K, 27)

        def at(ds, dy, dx):
            return C[..., ((ds + 1) * 3 + (dy + 1)) * 3 + (dx + 1)]

        D0 = at(0, 0, 0)
        return (
            D0,
            0.5 * (at(0, 0, 1) - at(0, 0, -1)),                   # Dx
            0.5 * (at(0, 1, 0) - at(0, -1, 0)),                   # Dy
            0.5 * (at(1, 0, 0) - at(-1, 0, 0)),                   # Ds
            at(0, 0, 1) + at(0, 0, -1) - 2 * D0,                  # Dxx
            at(0, 1, 0) + at(0, -1, 0) - 2 * D0,                  # Dyy
            at(1, 0, 0) + at(-1, 0, 0) - 2 * D0,                  # Dss
            0.25 * (at(0, 1, 1) + at(0, -1, -1)
                    - at(0, -1, 1) - at(0, 1, -1)),               # Dxy
            0.25 * (at(1, 0, 1) + at(-1, 0, -1)
                    - at(1, 0, -1) - at(-1, 0, 1)),               # Dxs
            0.25 * (at(1, 1, 0) + at(-1, -1, 0)
                    - at(1, -1, 0) - at(-1, 1, 0)),               # Dys
        )

    def solve3(d):
        """Closed-form solve A·sol = −g from the derivative rows."""
        gx, gy, gs = d[1], d[2], d[3]
        a, e, i = d[4], d[5], d[6]
        b, c, f = d[7], d[8], d[9]  # Dxy, Dxs, Dys
        A11, A12, A13 = e * i - f * f, -(b * i - f * c), b * f - e * c
        A22, A23 = a * i - c * c, -(a * f - b * c)
        A33 = a * e - b * b
        det = a * A11 + b * A12 + c * A13
        inv_det = torch.where(torch.abs(det) < 1e-15, 0.0, 1.0 / det)
        sx = -(A11 * gx + A12 * gy + A13 * gs) * inv_det
        sy = -(A12 * gx + A22 * gy + A23 * gs) * inv_det
        ss = -(A13 * gx + A23 * gy + A33 * gs) * inv_det
        return sx, sy, ss

    # Clamp starting points so gathers stay in range even for invalid slots
    s0 = torch.clamp(s, 0, S2 - 3) + 1  # center image of the DoG triplet
    iy = torch.clamp(y, 1, H - 2)
    ix = torch.clamp(x, 1, W - 2)
    fx = fy = fs = torch.zeros((V, K), dtype=dogs.dtype, device=dogs.device)
    for _ in range(5):
        fx, fy, fs = solve3(deriv_at(ix, iy, s0))
        dx = (((fx > 0.6) & (ix < W - 2)).long() - ((fx < -0.6) & (ix > 1)).long())
        dy = (((fy > 0.6) & (iy < H - 2)).long() - ((fy < -0.6) & (iy > 1)).long())
        ix, iy = ix + dx, iy + dy
    d = deriv_at(ix, iy, s0)
    val = d[0] + 0.5 * (d[1] * fx + d[2] * fy + d[3] * fs)
    Dxx, Dyy, Dxy = d[4], d[5], d[7]
    h_trace = Dxx + Dyy
    h_det = Dxx * Dyy - Dxy * Dxy
    h_score = h_trace * h_trace / torch.where(torch.abs(h_det) < 1e-20, 1e-20, h_det)
    score_thres = (EDGE_RATIO + 1.0) ** 2 / EDGE_RATIO

    kx = ix.to(torch.float32) + fx
    ky = iy.to(torch.float32) + fy
    ks = (s0 - 1).to(torch.float32) + fs
    ok = (valid
          & (torch.abs(val) >= CONTRAST_THRESHOLD)
          & (h_score >= 0.0) & (h_score <= score_thres)
          & (torch.abs(fx) <= 1.5) & (torch.abs(fy) <= 1.5) & (torch.abs(fs) <= 1.0)
          & (ks >= -1.0) & (ks <= float(SAMPLES))
          & (kx >= 0.0) & (kx <= float(W - 1))
          & (ky >= 0.0) & (ky <= float(H - 1)))
    return kx, ky, ks, ok


# ---------------------------------------------------------------------------
# Gradients, orientations, descriptors


def grad_ori_images(imgs):
    """Gradient magnitude + orientation ∈ [0, 2π) per sample image
    (sift.cc:556-594); imgs (V, S3, H, W). Border pixels carry zeros."""
    dx = 0.5 * (torch.roll(imgs, -1, dims=-1) - torch.roll(imgs, 1, dims=-1))
    dy = 0.5 * (torch.roll(imgs, -1, dims=-2) - torch.roll(imgs, 1, dims=-2))
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    ori = torch.where(ori < 0.0, ori + TWO_PI, ori)
    border = _interior(imgs.shape[-2], imgs.shape[-1], imgs.device)
    return mag * border, ori * border


def _rel_scale(sample):
    return BASE_BLUR * torch.pow(2.0, (sample + 1.0) / SAMPLES)


def _hat(u):
    """Linear interpolation hat max(0, 1−|u|): the reference's trilinear
    corner weights (sift.cc:793-806)."""
    return torch.clamp(1.0 - torch.abs(u), min=0.0)


def _gather_patches_flat(stack, vi, is_, iy, ix, size: int):
    """(V, S3, H, W) stack → (C, size, size) patches centered at each flat
    keypoint (view vi, scale image is_, pixel (iy, ix)), clamped to bounds.
    Returns (patches, y0, x0)."""
    V, S3, H, W = stack.shape
    r = size // 2
    y0 = torch.clamp(iy - r, 0, max(H - size, 0))
    x0 = torch.clamp(ix - r, 0, max(W - size, 0))
    ar = torch.arange(size, device=stack.device)
    s = torch.clamp(is_, 0, S3 - 1)
    patches = stack[vi[:, None, None], s[:, None, None],
                    (y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    return patches, y0, x0


def _patch_offsets(y0, x0, iy, ix, patch: int):
    ar = torch.arange(patch, dtype=torch.int64, device=y0.device)
    dy = (ar[None, :, None] + (y0 - iy)[:, None, None]).to(torch.float32)
    dx = (ar[None, None, :] + (x0 - ix)[:, None, None]).to(torch.float32)
    return dy, dx


def _orientations_block(grads, oris, vi, kx, ky, ks, patch: int):
    """36-bin histogram orientation assignment for a flat keypoint block
    (sift.cc:598-667). grads/oris (V, S3, H, W); keypoint arrays (C,).
    Returns (orientations (C, MAX_ORIENTATIONS), ok (C, MAX_ORIENTATIONS))."""
    H, W = grads.shape[-2:]
    C = kx.shape[0]
    ix = torch.floor(kx + 0.5).to(torch.int64)
    iy = torch.floor(ky + 0.5).to(torch.int64)
    is_ = torch.round(ks).to(torch.int64) + 1
    sigma = _rel_scale(ks)
    win = (sigma * 1.5 * 3.0).to(torch.int64)
    in_bounds = ((ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)
                 & (win <= patch // 2))

    gpatch, y0, x0 = _gather_patches_flat(grads, vi, is_, iy, ix, patch)
    opatch, _, _ = _gather_patches_flat(oris, vi, is_, iy, ix, patch)
    dy, dx = _patch_offsets(y0, x0, iy, ix, patch)
    dxf = (kx - ix.to(torch.float32))[:, None, None]
    dyf = (ky - iy.to(torch.float32))[:, None, None]
    dist = (dx - dxf) ** 2 + (dy - dyf) ** 2
    winf = win.to(torch.float32)[:, None, None]
    maxdist = winf * winf + 0.5
    inside = (dist <= maxdist) & (torch.abs(dx) <= winf) & (torch.abs(dy) <= winf)
    sig15 = (sigma * 1.5)[:, None, None]
    weight = torch.exp(-dist / (2.0 * sig15 * sig15))
    contrib = torch.where(inside, gpatch * weight, 0.0).reshape(C, -1)
    bins = torch.clamp((N_ORI_BINS * opatch / TWO_PI).to(torch.int64),
                       0, N_ORI_BINS - 1).reshape(C, -1)
    hist = torch.stack([torch.sum(torch.where(bins == b, contrib, 0.0), dim=-1)
                        for b in range(N_ORI_BINS)], dim=-1)  # (C, 36)

    # Smooth 6x with a circular [1,1,1]/3 kernel (sift.cc:641-653)
    for _ in range(6):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0

    maxh = torch.max(hist, dim=-1, keepdim=True).values
    h0 = torch.roll(hist, 1, -1)
    h2 = torch.roll(hist, -1, -1)
    is_peak = (hist > 0.8 * maxh) & (hist > h0) & (hist > h2)
    denom = h0 - 2.0 * hist + h2
    xoff = -0.5 * (h2 - h0) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    bins_f = torch.arange(N_ORI_BINS, device=kx.device)
    angles = TWO_PI * (xoff + bins_f + 0.5) / N_ORI_BINS

    top_vals, top_idx = _top_k_small(torch.where(is_peak, hist, -1.0), MAX_ORIENTATIONS)
    ori_out = torch.gather(angles, -1, top_idx)
    ori_ok = (top_vals > 0.0) & in_bounds[:, None]
    return ori_out, ori_ok


def _descriptors_block(grads, oris, vi, kx, ky, ks, ori4, patch: int):
    """4x4x8 trilinear SIFT descriptors for a flat keypoint block
    (sift.cc:669-843); ori4 (C, MAX_ORIENTATIONS) candidate orientations.
    desc[by, bx, bt] = Σ_px Wy[px,by]·Wx[px,bx]·Wt[px,bt]·contrib[px] with
    hat weights (circular for bt); the patch is gathered once per keypoint.
    Returns (desc (C, MAX_ORIENTATIONS, 128), in_bounds (C,))."""
    H, W = grads.shape[-2:]
    C = kx.shape[0]
    PXB, OHB = 4, 8
    ix = torch.floor(kx + 0.5).to(torch.int64)
    iy = torch.floor(ky + 0.5).to(torch.int64)
    is_ = torch.round(ks).to(torch.int64) + 1
    sigma = _rel_scale(ks)
    binsize = 3.0 * sigma  # (C,)
    win = (math.sqrt(2.0) * binsize * (PXB + 1) * 0.5).to(torch.int64)
    in_bounds = ((ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)
                 & (win <= patch // 2))

    gpatch, y0, x0 = _gather_patches_flat(grads, vi, is_, iy, ix, patch)
    opatch, _, _ = _gather_patches_flat(oris, vi, is_, iy, ix, patch)
    dy, dx = _patch_offsets(y0, x0, iy, ix, patch)
    winf = win.to(torch.float32)[:, None, None]
    window = (torch.abs(dx) <= winf) & (torch.abs(dy) <= winf)
    winx = dx - (kx - ix.to(torch.float32))[:, None, None]
    winy = dy - (ky - iy.to(torch.float32))[:, None, None]

    # The Gaussian spatial weight is rotation-invariant, so contrib is shared
    # by all orientations
    gsigma = 0.5 * PXB
    bs = binsize[:, None, None]
    gweight = torch.exp(-(winx * winx + winy * winy) / (bs * bs * 2.0 * gsigma * gsigma))
    P2 = patch * patch
    contrib = torch.where(window, gpatch * gweight, 0.0).reshape(C, P2)

    binoff = (PXB - 1) / 2.0
    bins_x = torch.arange(PXB, dtype=torch.float32, device=kx.device)
    bins_t = torch.arange(OHB, dtype=torch.float32, device=kx.device)
    descs = []
    for m in range(MAX_ORIENTATIONS):
        ori = ori4[:, m]
        sino = torch.sin(ori)[:, None, None]
        coso = torch.cos(ori)[:, None, None]
        binx = ((coso * winx + sino * winy) / bs + binoff).reshape(C, P2)
        biny = ((-sino * winx + coso * winy) / bs + binoff).reshape(C, P2)
        theta = opatch - ori[:, None, None]
        theta = torch.where(theta < 0.0, theta + TWO_PI, theta)
        bint = (theta * OHB / TWO_PI - 0.5).reshape(C, P2)

        Wx = _hat(binx[:, :, None] - bins_x)  # (C, P², 4)
        Wy = _hat(biny[:, :, None] - bins_x)  # (C, P², 4)
        dt = bint[:, :, None] - bins_t
        dt = dt - OHB * torch.round(dt / OHB)  # circular distance
        Ct = _hat(dt) * contrib[:, :, None]  # (C, P², 8)
        G = (Wy[:, :, :, None] * Wx[:, :, None, :]).reshape(C, P2, PXB * PXB)
        d = torch.bmm(G.transpose(1, 2), Ct).reshape(C, 128)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        d = torch.clamp(d, max=0.2)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        descs.append(d)
    return torch.stack(descs, dim=1), in_bounds


def _ori_desc_flat(grads, oris, kp, ori_patch: int, desc_patch: int):
    """Orientation + descriptor stages over a flat compacted keypoint array
    kp (B, 4) of [view, x, y, sample] rows, in chunks.
    Returns (ori4 (B, M), ok (B, M), desc (B, M, 128) zeroed where not ok)."""
    outs = []
    for c in range(0, kp.shape[0], ORI_DESC_CHUNK):
        kp_c = kp[c:c + ORI_DESC_CHUNK]
        vi = kp_c[:, 0].to(torch.int64)
        kx, ky, ks = kp_c[:, 1], kp_c[:, 2], kp_c[:, 3]
        ori4, ori_ok = _orientations_block(grads, oris, vi, kx, ky, ks, ori_patch)
        desc, d_ok = _descriptors_block(grads, oris, vi, kx, ky, ks, ori4, desc_patch)
        ok = ori_ok & d_ok[:, None]
        outs.append((ori4, ok, torch.where(ok[:, :, None], desc, 0.0)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _detect_octave_batch(bases, has_sigma: float, cap: int):
    """Pyramid + extrema + localization + gradient images for one octave over
    a (V, H, W) view stack. Returns a (V, cap, 4) keypoint tensor
    [x, y, sample, valid] plus the (V, S3, H, W) gradient-magnitude and
    orientation stacks."""
    imgs, dogs = build_octave(bases, has_sigma)
    s, y, x, valid = detect_extrema(dogs, cap)
    kx, ky, ks, valid = localize_keypoints(dogs, s, y, x, valid)
    del dogs
    grads, oris = grad_ori_images(imgs)
    return torch.stack([kx, ky, ks, valid.to(torch.float32)], dim=-1), grads, oris


def _octave_cap(per_octave_cap: int, h: int, w: int) -> int:
    """Per-octave keypoint capacity: the configured cap, shrunk with the
    octave's pixel count (an extremum needs a 3x3x3 neighbourhood, so dense
    small octaves cannot fill the full-resolution capacity)."""
    return max(256, min(per_octave_cap, (h * w) // 64))


def double_size_supersample(img):
    """2x upscale by 4-tap supersampling with edge clamping over (..., H, W):
    MVE's rescale_double_size_supersample (mve/mve/image_tools.h:790-826)."""
    a = img
    right = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    diag = torch.cat([down[..., 1:], down[..., -1:]], dim=-1)
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    top = torch.stack([a, 0.5 * (a + right)], dim=-1).reshape(*lead, H, 2 * W)
    bot = torch.stack([0.5 * (a + down), 0.25 * (a + right + down + diag)],
                      dim=-1).reshape(*lead, H, 2 * W)
    return torch.stack([top, bot], dim=-2).reshape(*lead, 2 * H, 2 * W)


def _octave_plan(H: int, W: int, per_octave_cap: int, max_octave: int, min_octave: int):
    """(octave, cap, h, w) schedule for an input shape."""
    plan = []
    h, w = H, W
    for o in range(min_octave, max_octave + 1):
        if o == -1:
            h, w = 2 * H, 2 * W
        elif o == 0:
            h, w = H, W
        if min(h, w) < 16:
            break
        plan.append((o, _octave_cap(per_octave_cap, h, w), h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return plan


#: View-chunking budget for extract_batch, by the JAX package's estimate of
#: ~230 bytes per pixel (held gradient stacks + octave-0 detection transients)
MEMORY_BUDGET_BYTES = 40_000_000_000


def extract(image_gray, per_octave_cap: int = 2048, max_octave: int = MAX_OCTAVE,
            min_octave: int = 0) -> Features:
    """Multi-octave SIFT on one (H, W) grayscale float image: the V = 1 case
    of extract_batch, so both give bit-identical features. Fields as
    extract_batch's without the leading view axis."""
    fb = extract_batch(torch.as_tensor(image_gray)[None], per_octave_cap, max_octave,
                       min_octave)
    return Features(*(f[0] for f in fb))


def extract_batch(images, per_octave_cap: int = 2048, max_octave: int = MAX_OCTAVE,
                  min_octave: int = 0) -> Features:
    """Batched multi-octave SIFT over a (V, H, W) stack of same-shape images.

    Returned fields carry a leading V axis and a fixed per-view slot layout
    (Σ_o cap_o·M slots; invalid slots zeroed): xy, scale, orientation, valid
    host numpy, desc a (V, slots, 128) tensor on the images' device.
    Coordinates are input-image pixels, x_img = 2^o·(x+0.5)−0.5
    (sift.cc:545-547). min_octave = −1 prepends the 2x upscale octave."""
    assert min_octave >= -1, "octaves below -1 are not defined"
    V, H, W = images.shape
    up = 2 if min_octave <= -1 else 1
    per_view_bytes = int(230 * (up * H) * (up * W))
    chunk = max(1, min(V, MEMORY_BUDGET_BYTES // max(per_view_bytes, 1)))
    if chunk < V:
        parts = [extract_batch(images[i:i + chunk], per_octave_cap, max_octave, min_octave)
                 for i in range(0, V, chunk)]
        return Features(*(torch.cat(f) if isinstance(f[0], torch.Tensor)
                          else np.concatenate(f) for f in zip(*parts)))

    plan = _octave_plan(H, W, per_octave_cap, max_octave, min_octave)
    M = MAX_ORIENTATIONS

    # Phase 1: detection per octave over the stack, then ONE keypoint pull
    with stage("sift/pyramid_detect"):
        dets = []
        img, has_sigma = images, INHERENT_BLUR
        for o, cap, h, w in plan:
            if o == -1:
                img, has_sigma = double_size_supersample(images), INHERENT_BLUR * 2.0
            elif o == 0:
                # Octave 0 always starts from the original image (sift.cc:195-199)
                img, has_sigma = images, INHERENT_BLUR
            dets.append(_detect_octave_batch(img, has_sigma, cap))
            if o >= 0:
                img, has_sigma = half_size_gaussian(img), BASE_BLUR
        kp_all = torch.cat([kp for kp, _, _ in dets], dim=1).cpu().numpy()  # (V, Σcap, 4)

    # Phase 2: compact each octave's valid keypoints on the host and run the
    # orientation/descriptor stages on them; ONE pull of all orientations
    with stage("sift/ori_desc"):
        launched, off = [], 0
        for (o, cap, h, w), (_, grads, oris) in zip(plan, dets):
            kp_np = kp_all[:, off:off + cap]
            off += cap
            vi_np, ki_np = np.nonzero(kp_np[:, :, 3] > 0.5)
            kxyz = kp_np[vi_np, ki_np, :3]
            desc = torch.zeros((V, cap * M, 128), dtype=torch.float32, device=images.device)
            ori_ok = None
            if len(vi_np):
                kp_flat = np.concatenate([vi_np[:, None].astype(np.float32), kxyz], axis=1)
                ori4, ok, d = _ori_desc_flat(
                    grads, oris, torch.as_tensor(kp_flat, device=images.device),
                    min(ORI_PATCH, _odd(h), _odd(w)), min(DESC_PATCH, _odd(h), _odd(w)))
                slots = torch.as_tensor(ki_np[:, None] * M + np.arange(M), device=images.device)
                desc[torch.as_tensor(vi_np, device=images.device)[:, None], slots] = d
                ori_ok = torch.stack([ori4, ok.to(torch.float32)], dim=-1)
            launched.append((o, cap, vi_np, ki_np, kxyz, desc, ori_ok))
        del dets
    pulled = [p[-1] for p in launched if p[-1] is not None]
    pulled = torch.cat(pulled).cpu().numpy() if pulled else np.zeros((0, M, 2), np.float32)

    # Phase 3: per-octave slot arrays in input-image coordinates
    xys, scales, oris_out, valids, descs = [], [], [], [], []
    row = 0
    for o, cap, vi_np, ki_np, kxyz, desc, ori_ok in launched:
        n = len(vi_np)
        x = np.zeros((V, cap * M), np.float32)
        y = np.zeros((V, cap * M), np.float32)
        sample = np.zeros((V, cap * M), np.float32)
        orientation = np.zeros((V, cap * M), np.float32)
        valid = np.zeros((V, cap * M), bool)
        if n:
            slots = ki_np[:, None] * M + np.arange(M)[None, :]
            vrep = np.broadcast_to(vi_np[:, None], slots.shape)
            x[vrep, slots] = kxyz[:, None, 0]
            y[vrep, slots] = kxyz[:, None, 1]
            sample[vrep, slots] = kxyz[:, None, 2]
            orientation[vrep, slots] = pulled[row:row + n, :, 0]
            valid[vrep, slots] = pulled[row:row + n, :, 1] > 0.5
            row += n
        sf = 2.0**o
        xys.append(np.stack([sf * (x + 0.5) - 0.5, sf * (y + 0.5) - 0.5], -1))
        scales.append(BASE_BLUR * 2.0 ** (o + (sample + 1.0) / SAMPLES))
        oris_out.append(orientation)
        valids.append(valid)
        descs.append(desc)
    return Features(xy=np.concatenate(xys, axis=1), scale=np.concatenate(scales, axis=1),
                    orientation=np.concatenate(oris_out, axis=1),
                    desc=torch.cat(descs, dim=1), valid=np.concatenate(valids, axis=1))
