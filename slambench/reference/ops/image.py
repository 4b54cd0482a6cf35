"""Image ops (counterpart of nrslam_tpu/ops/image.py): grayscale, CLAHE,
pyramid, Scharr gradients, bilinear sampling and window gathers, erosion /
dilation and the Gaussian blur.

Float32 images in [0, 255], shape [H, W]; borders replicate (edge padding)
exactly as the JAX package's shifted-slice stencils do. The outputs match
the JAX package's; its layout choices for the TPU are not copied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PYRDOWN_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img, pad: int):
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def pyr_down(img):
    """[1,4,6,4,1]/16 separable blur then 2x decimation (cv::pyrDown)."""
    k = _PYRDOWN_K
    x = _edge_pad(img, 2)
    r = (k[0] * x[:-4] + k[1] * x[1:-3] + k[2] * x[2:-2]
         + k[3] * x[3:-1] + k[4] * x[4:])
    r = r[::2]
    b = (k[0] * r[:, :-4] + k[1] * r[:, 1:-3] + k[2] * r[:, 2:-2]
         + k[3] * r[:, 3:-1] + k[4] * r[:, 4:])
    return b[:, ::2].contiguous()


def scharr_gradients(img):
    """Unnormalized Scharr x/y derivatives stacked [H, W, 2]."""
    x = _edge_pad(img, 1)
    dx = x[:, 2:] - x[:, :-2]
    gx = 3.0 * dx[:-2] + 10.0 * dx[1:-1] + 3.0 * dx[2:]
    dy = x[2:, :] - x[:-2, :]
    gy = 3.0 * dy[:, :-2] + 10.0 * dy[:, 1:-1] + 3.0 * dy[:, 2:]
    return torch.stack([gx, gy], dim=-1)


def build_pyramid(img, num_levels: int):
    """List of (image, gradients) per level, level 0 = full resolution."""
    levels = []
    cur = img
    for _ in range(num_levels):
        levels.append((cur, scharr_gradients(cur)))
        cur = pyr_down(cur)
    return levels


def dilate(mask, ksize: int):
    """Binary dilation with a ksize x ksize box (out-of-image is False)."""
    pad = ksize // 2
    x = F.pad(mask.to(torch.float32)[None, None],
              (pad, ksize - 1 - pad, pad, ksize - 1 - pad))
    x = F.max_pool2d(x, (ksize, 1), stride=1)
    x = F.max_pool2d(x, (1, ksize), stride=1)
    return x[0, 0] > 0.5


def rgb_to_gray(rgb):
    """[H, W, 3] uint8/float RGB -> [H, W] float32 gray (OpenCV weights)."""
    rgb = rgb.to(torch.float32)
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def clahe(image, clip_limit: float = 3.0, grid: int = 8, n_bins: int = 256):
    """Contrast-limited adaptive histogram equalisation (the algorithm of
    cv::createCLAHE(3.0, Size(8, 8))): per-tile clipped histograms with
    uniform excess redistribution, rounded CDF LUTs, bilinear interpolation
    between the four neighbouring tiles. H and W divisible by ``grid``."""
    H, W = image.shape
    th, tw = H // grid, W // grid
    x = torch.clamp(image, 0.0, 255.0)
    tiles = x.reshape(grid, th, grid, tw).permute(0, 2, 1, 3) \
        .reshape(grid * grid, th * tw)
    bins = torch.clamp((tiles * (n_bins / 256.0)).to(torch.int64), 0,
                       n_bins - 1)
    hist = torch.zeros((grid * grid, n_bins), dtype=torch.float32,
                       device=image.device)
    hist.scatter_add_(1, bins, torch.ones_like(tiles))

    clip = max(clip_limit * (th * tw) / n_bins, 1.0)
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=-1,
                       keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / n_bins
    luts = torch.round(torch.cumsum(hist, dim=-1) * ((n_bins - 1.0)
                                                     / (th * tw)))
    luts = luts.reshape(grid, grid, n_bins)

    def axis(n, t):
        c = (torch.arange(n, dtype=torch.float32, device=image.device)
             + 0.5) / t - 0.5
        i0 = torch.clamp(torch.floor(c).to(torch.int64), 0, grid - 1)
        i1 = torch.clamp(i0 + 1, 0, grid - 1)
        w = torch.clamp(c - torch.floor(c), 0.0, 1.0)
        w = torch.where(c < 0, torch.zeros_like(w),
                        torch.where(c > grid - 1, torch.ones_like(w), w))
        return i0, i1, w

    y0, y1, wy = axis(H, th)
    x0, x1, wx = axis(W, tw)
    wy, wx = wy[:, None], wx[None, :]
    pix_bin = torch.clamp((x * (n_bins / 256.0)).to(torch.int64), 0,
                          n_bins - 1)

    def gather(tyi, txi):
        return luts[tyi[:, None], txi[None, :], pix_bin]

    return ((1 - wy) * ((1 - wx) * gather(y0, x0) + wx * gather(y0, x1))
            + wy * ((1 - wx) * gather(y1, x0) + wx * gather(y1, x1)))


def bilinear_sample(img, uv):
    """Sample an [H, W] or [H, W, C] image at continuous (x, y) positions
    ``uv[..., :2]`` (x = column), clamped to the interpolation domain."""
    H, W = img.shape[0], img.shape[1]
    x = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), max=W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), max=H - 2)
    fx = x - x0
    fy = y - y0
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def gather_windows(img, centers, win: int):
    """``win`` x ``win`` bilinear windows around continuous (x, y) centers
    [..., 2]: [..., win, win] (or [..., win, win, C] for an [H, W, C]
    image). A window spans ``center - (win - 1) / 2 .. center + (win - 1) /
    2``."""
    offs = (torch.arange(win, dtype=torch.float32, device=centers.device)
            - (win - 1) * 0.5)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([ox, oy], dim=-1)                     # [win, win, 2]
    return bilinear_sample(img, centers[..., None, None, :] + grid)


def erode(mask, ksize: int):
    """Binary erosion with a ksize x ksize box (out-of-image is False)."""
    pad = ksize // 2
    x = F.pad(mask.to(torch.float32)[None, None],
              (pad, ksize - 1 - pad, pad, ksize - 1 - pad))
    x = -F.max_pool2d(-x, (ksize, 1), stride=1)
    x = -F.max_pool2d(-x, (1, ksize), stride=1)
    return x[0, 0] > 0.5


def gaussian_blur(img, ksize: int, sigma: float = 0.0):
    """Separable Gaussian blur with replicated borders (cv::GaussianBlur's
    sigma for sigma <= 0)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(xs * xs) / (2 * sigma * sigma))
    k = k / torch.sum(k)
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    x = sum(k[i] * x[i:i + H, :] for i in range(ksize))
    x = F.pad(x[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    return sum(k[i] * x[:, i:i + W] for i in range(ksize))
