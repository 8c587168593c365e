"""Digits, image, blob and ratings datasets (numpy).

Copy of the JAX package's ``train/data.py``, so both packages draw the
same arrays from the same seed. The reference slices
misc/digits.png into 16x16 grayscale patterns, 10 classes, 800 train /
200 validation (examples/APRIL-ANN/init.lua:80-123): ``make_digits``
generates a dataset with that shape and split from a seed,
``load_digits_image`` slices a real sheet and ``write_digits_image``
renders a deterministic one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_CLASSES = 10
DIM = 256                # 16x16 (init.lua digit patterns)
N_TRAIN = 800            # init.lua:80-123 split
N_VAL = 200


def make_digits(seed: int = 0, n_train: int = N_TRAIN, n_val: int = N_VAL,
                dim: int = DIM, noise: float = 0.35
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_val, y_val); x in [0,1]^dim float32."""
    rng = np.random.RandomState(seed)
    prototypes = rng.rand(N_CLASSES, dim).astype(np.float32)

    def sample(n):
        y = rng.randint(0, N_CLASSES, size=n)
        x = prototypes[y] + noise * rng.randn(n, dim).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_va, y_va = sample(n_val)
    return x_tr, y_tr, x_va, y_va


def make_blobs(seed: int = 0, n: int = 2048, k: int = 8, dim: int = 16,
               spread: float = 0.15
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian blobs for the k-means workload (BASELINE.json config 5):
    (points (n, dim), labels (n,), true centers (k, dim)), deterministic
    in the seed."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(k, dim).astype(np.float32)
    y = rng.randint(0, k, n)
    x = centers[y] + spread * rng.randn(n, dim).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32), centers


def make_ratings(seed: int = 0, n_users: int = 256, n_items: int = 64,
                 rank: int = 4, density: float = 0.3, noise: float = 0.01
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Low-rank ratings matrix + observation mask for the ALS workload
    (BASELINE.json config 5). R = U Vᵀ + noise is exactly rank-``rank``
    up to the noise, so ALS at that rank drives masked RMSE → noise."""
    rng = np.random.RandomState(seed)
    u = rng.randn(n_users, rank).astype(np.float32)
    v = rng.randn(n_items, rank).astype(np.float32)
    r = u @ v.T + noise * rng.randn(n_users, n_items).astype(np.float32)
    w = (rng.rand(n_users, n_items) < density).astype(np.float32)
    return r.astype(np.float32), w


def make_images(seed: int = 0, n_train: int = 2048, n_val: int = 512,
                shape: Tuple[int, int, int] = (32, 32, 3),
                n_classes: int = N_CLASSES, noise: float = 0.3
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic CIFAR/ImageNet-shaped image classification data (the
    LeNet-5 / ResNet-18 configurations): NHWC images in [0, 1], class
    prototypes of low-frequency sinusoids per channel plus per-sample
    noise; deterministic in the seed, with the JAX package's RNG call
    order."""
    h, w, c = shape
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.empty((n_classes, h, w, c), np.float32)
    for cls in range(n_classes):
        for ch in range(c):
            fy, fx = rng.uniform(0.5, 3.0, size=2)
            phase = rng.uniform(0, 2 * np.pi)
            protos[cls, :, :, ch] = 0.5 + 0.5 * np.sin(
                2 * np.pi * (fy * yy / h + fx * xx / w) + phase)

    def sample(n):
        y = rng.randint(0, n_classes, size=n)
        x = protos[y] + noise * rng.randn(n, h, w, c).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_va, y_va = sample(n_val)
    return x_tr, y_tr, x_va, y_va


def load_digits_image(path: str
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Slice a digits sheet image into the reference's dataset
    (init.lua:80-123): a grid of 16x16 glyphs, 10 per row (one column
    per class), read as grayscale, inverted (ink -> high activation),
    scaled to [0, 1]. The first 4/5 of the tile-rows train, the rest
    validate; labels cycle 0-9 with the column, patterns advance
    column-fastest. Any (16*R, 160) image with R a multiple of 5 is
    accepted. Returns (x_train (N,256) f32, y_train (N,) i32, x_val,
    y_val).
    """
    from PIL import Image

    img = Image.open(path).convert("L")
    w, h = img.size
    if w != 160 or h % 16 or (h // 16) % 5:
        raise ValueError(
            f"digits sheet must be 160px wide (10 glyph columns) with a "
            f"tile-row count divisible by 5 for the 4:1 split; got "
            f"{w}x{h}")
    a = np.asarray(img, np.float32) / 255.0
    a = 1.0 - a                                   # invert_colors
    rows = h // 16
    # (rows, 16, 10, 16) -> (rows, 10, 256): column-fastest pattern order
    tiles = a.reshape(rows, 16, 10, 16).transpose(0, 2, 1, 3)
    patterns = tiles.reshape(rows * 10, 256).astype(np.float32)
    labels = (np.arange(rows * 10) % 10).astype(np.int32)
    n_tr = (rows * 4 // 5) * 10
    return (patterns[:n_tr], labels[:n_tr],
            patterns[n_tr:], labels[n_tr:])


def write_digits_image(path: str, seed: int = 0, tile_rows: int = 100
                       ) -> None:
    """Render a deterministic digits sheet honoring the loader's
    contract (used to generate the checked-in test fixture and to
    produce a full-size 1600x160 stand-in for the reference's
    misc/digits.png when none is at hand). Glyphs are per-class
    prototype blobs + per-instance noise, drawn as INK on paper so the
    loader's inversion is exercised.

    Glyphs are seven-segment digit renderings with per-instance jitter
    (±1 px glyph offset, ink-intensity variation, paper noise) — the
    classes differ by SHAPE, like the reference's scanned sheet, not
    merely by a per-class noise prototype, so a model scoring high
    validation accuracy here has learned actual digit geometry."""
    from PIL import Image

    # segment rectangles in a 16x16 tile: (row0, row1, col0, col1)
    seg_rc = {
        "A": (2, 4, 5, 11),       # top bar
        "B": (3, 8, 11, 13),      # top-right
        "C": (8, 13, 11, 13),     # bottom-right
        "D": (12, 14, 5, 11),     # bottom bar
        "E": (8, 13, 3, 5),       # bottom-left
        "F": (3, 8, 3, 5),        # top-left
        "G": (7, 9, 5, 11),       # middle bar
    }
    digit_segs = ["ABCDEF", "BC", "ABGED", "ABGCD", "FGBC", "AFGCD",
                  "AFGECD", "ABC", "ABCDEFG", "ABCDFG"]

    rng = np.random.RandomState(seed)
    sheet = np.zeros((tile_rows * 16, 160), np.float32)
    for r in range(tile_rows):
        for c in range(10):
            glyph = np.zeros((16, 16), np.float32)
            for s in digit_segs[c]:
                r0, r1, c0, c1 = seg_rc[s]
                glyph[r0:r1, c0:c1] = 0.7 + 0.3 * rng.rand()
            dy, dx = rng.randint(-1, 2, 2)          # pen-position jitter
            glyph = np.roll(np.roll(glyph, dy, 0), dx, 1)
            glyph += 0.08 * rng.randn(16, 16)       # paper/scan noise
            sheet[r * 16:(r + 1) * 16,
                  c * 16:(c + 1) * 16] = np.clip(glyph, 0.0, 1.0)
    paper = np.clip(1.0 - sheet, 0.0, 1.0)          # ink -> dark
    Image.fromarray((paper * 255).astype(np.uint8), "L").save(path)
