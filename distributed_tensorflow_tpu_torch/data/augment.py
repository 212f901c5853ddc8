"""Host-side image augmentation of the input pipeline — the port's copy of
``distributed_tensorflow_tpu/data/augment.py`` (numpy; PIL imported inside
the two resizing functions).

Augmentation runs on the host, where per-image branching (crop offsets,
flips) overlaps the card's step through the ``Prefetcher``; the card sees
dense, statically shaped batches. Every draw comes from a caller's
``np.random.RandomState`` seeded per (seed, batch index), in the JAX
package's order, so a resume at step N reproduces batches N, N+1, ...
bit for bit, and the same seed gives the JAX package's augmentation.
"""

from __future__ import annotations

import numpy as np


def random_crop_flip(images: np.ndarray, rng: np.random.RandomState, *,
                     padding: int = 4) -> np.ndarray:
    """The CIFAR train recipe over a [B, H, W, C] batch: zero-pad by
    ``padding``, one random H x W window an image, then a horizontal flip
    of about half of them (one gather and one masked flip)."""
    b, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    ys = rng.randint(0, 2 * padding + 1, b)
    xs = rng.randint(0, 2 * padding + 1, b)
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    out = windows[np.arange(b), ys, xs]  # [B, C, H, W]
    out = np.ascontiguousarray(np.moveaxis(out, 1, -1))
    flips = rng.rand(b) < 0.5
    out[flips] = out[flips, :, ::-1]
    return out


def sample_crop_rect(h: int, w: int, rng: np.random.RandomState, *,
                     scale: tuple[float, float] = (0.08, 1.0),
                     ratio: tuple[float, float] = (3 / 4, 4 / 3),
                     attempts: int = 10) -> tuple[int, int, int, int]:
    """The Inception recipe's area/aspect crop (y, x, ch, cw) of an H x W
    image, the centred square when no draw fits. The one definition of
    the crop policy: the PIL path (``random_resized_crop``) and the native
    libjpeg decoder (``data/native_jpeg.py``) draw the same rects from the
    same generator states."""
    area = h * w
    for _ in range(attempts):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            return y, x, ch, cw
    side = min(h, w)
    return max(0, (h - side) // 2), max(0, (w - side) // 2), side, side


def random_resized_crop(image: np.ndarray, rng: np.random.RandomState, out_size: int, *,
                        scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3),
                        attempts: int = 10) -> np.ndarray:
    """The ImageNet train crop of ONE [H, W, C] uint8 image: a
    ``sample_crop_rect`` window resized to out_size x out_size (PIL
    bilinear)."""
    from PIL import Image

    h, w = image.shape[:2]
    y, x, ch, cw = sample_crop_rect(h, w, rng, scale=scale, ratio=ratio, attempts=attempts)
    pil = Image.fromarray(image[y:y + ch, x:x + cw])
    return np.asarray(pil.resize((out_size, out_size), Image.BILINEAR))


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """The centred size x size window of ONE [H, W, C] image."""
    h, w = image.shape[:2]
    y = max(0, (h - size) // 2)
    x = max(0, (w - size) // 2)
    return image[y:y + size, x:x + size]


def resize_center_crop(image: np.ndarray, out_size: int, *,
                       resize_frac: float = 0.875) -> np.ndarray:
    """The ImageNet eval recipe: the short side resized to
    out_size / resize_frac (PIL bilinear), then ``center_crop``."""
    from PIL import Image

    h, w = image.shape[:2]
    short = int(round(out_size / resize_frac))
    if h < w:
        nh, nw = short, max(short, int(round(w * short / h)))
    else:
        nh, nw = max(short, int(round(h * short / w))), short
    pil = Image.fromarray(image).resize((nw, nh), Image.BILINEAR)
    return center_crop(np.asarray(pil), out_size)


def hflip(image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """ONE [H, W, C] image flipped left-right with probability 1/2."""
    return image[:, ::-1] if rng.rand() < 0.5 else image
