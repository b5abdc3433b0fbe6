"""Input pipeline with the reference's split DSL (the port's own copy of
``superdiff_tpu/data/datasets.py``, numpy only: its batches are bit for bit
the JAX package's for the same data, split and seed).

Parity target: ``cifar/datasets.py:68-183``. The semantics of the
reference's tfds pipeline: uniform dequantization, random flips, [-1, 1]
scaling, and the split DSL that carves the datasets the two composed models
are trained on:

  ``train[:50%]`` / ``train[50%:]``  — percentage slices
  ``train<5`` / ``train>5``          — class-filtered splits (< is labels 0..4,
                                       > is labels 5..9; ``datasets.py:150-173``)

Datasets: CIFAR10, MNIST, SVHN, CELEBA (``cifar/datasets.py:98-137``), with
the reference's resize ops in a numpy bilinear resample (plain resize to
``image_size``; ``central_crop(140)`` + shrink for celeba).

Sources, in order of preference:
  1. local raw files under ``data_dir``, else under ``SUPERDIFF_DATA_DIR``
     (nothing is downloaded): CIFAR-10 python batches
     (``cifar-10-batches-py``), MNIST IDX files (``mnist/``), SVHN cropped
     ``.mat`` files (``svhn/``), CelebA aligned JPEGs
     (``celeba/img_align_celeba`` + optional ``list_eval_partition.txt``);
     the JAX module's fixed fallback directory is not kept: with neither
     given, no local file is read;
  2. a deterministic synthetic stand-in with the same shapes/labels so every
     pipeline stage can run end-to-end without the real data.

Batches are host numpy, shape (B, H, W, C) float32 in [0, 1] (then
scaled); the trainer moves them to the card.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from typing import Iterator, Optional, Tuple

import numpy as np

_SPLIT_RE = re.compile(
    r"^(?P<base>\w+)"
    r"(?:\[(?P<lo>\d+)?%?:(?P<hi>\d+)?%?\]|(?P<op>[<>])(?P<cls>\d+))?$"
)


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    base: str  # 'train' | 'test'
    lo_pct: Optional[int] = None
    hi_pct: Optional[int] = None
    class_op: Optional[str] = None  # '<' | '>'
    class_val: Optional[int] = None

    @staticmethod
    def parse(split: str) -> "SplitSpec":
        m = _SPLIT_RE.match(split.replace(" ", ""))
        if not m:
            raise ValueError(f"cannot parse split: {split!r}")
        d = m.groupdict()
        return SplitSpec(
            base=d["base"],
            lo_pct=int(d["lo"]) if d["lo"] else (0 if ":" in split else None),
            hi_pct=int(d["hi"]) if d["hi"] else (100 if ":" in split else None),
            class_op=d["op"],
            class_val=int(d["cls"]) if d["cls"] else None,
        )

    def apply(self, images: np.ndarray, labels: np.ndarray):
        if self.class_op == "<":
            mask = labels < self.class_val
            return images[mask], labels[mask]
        if self.class_op == ">":
            # reference semantics: 'train>5' keeps labels >= 5
            # (cifar/datasets.py filters the complement of '<5')
            mask = labels >= self.class_val
            return images[mask], labels[mask]
        n = len(images)
        lo = (self.lo_pct or 0) * n // 100
        hi = (self.hi_pct if self.hi_pct is not None else 100) * n // 100
        return images[lo:hi], labels[lo:hi]


def _load_cifar10_local(data_dir: str) -> Optional[Tuple[np.ndarray, ...]]:
    root = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(root):
        return None
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"]))
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    train_y = np.concatenate(ys)
    with open(os.path.join(root, "test_batch"), "rb") as f:
        d = pickle.load(f, encoding="bytes")
    test_x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    test_y = np.asarray(d[b"labels"])
    return train_x, train_y, test_x, test_y


def _read_idx(path: str) -> np.ndarray:
    """Parse one MNIST IDX file (optionally .gz): big-endian header of
    ``0x0000 dtype ndim`` then ``ndim`` uint32 dims, then raw uint8 data."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    assert data[0] == 0 and data[1] == 0 and data[2] == 0x08, "not a u8 IDX file"
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _load_mnist_local(data_dir: str) -> Optional[Tuple[np.ndarray, ...]]:
    root = os.path.join(data_dir, "mnist")
    if not os.path.isdir(root):
        return None

    def find(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(root, stem + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"{stem}[.gz] not under {root}")

    train_x = _read_idx(find("train-images-idx3-ubyte"))[..., None]
    train_y = _read_idx(find("train-labels-idx1-ubyte")).astype(np.int64)
    test_x = _read_idx(find("t10k-images-idx3-ubyte"))[..., None]
    test_y = _read_idx(find("t10k-labels-idx1-ubyte")).astype(np.int64)
    return train_x, train_y, test_x, test_y


def _load_svhn_local(data_dir: str) -> Optional[Tuple[np.ndarray, ...]]:
    """SVHN 'cropped digits' .mat files (X: (32,32,3,N) u8, y: 1..10 w/ 10=0)."""
    root = os.path.join(data_dir, "svhn")
    if not os.path.isdir(root):
        return None
    from scipy.io import loadmat

    def load(name):
        d = loadmat(os.path.join(root, name))
        x = d["X"].transpose(3, 0, 1, 2)
        y = d["y"].ravel().astype(np.int64) % 10
        return x, y

    train_x, train_y = load("train_32x32.mat")
    test_x, test_y = load("test_32x32.mat")
    return train_x, train_y, test_x, test_y


def _load_celeba_local(data_dir: str) -> Optional[Tuple[np.ndarray, ...]]:
    """CelebA aligned image-folder loader (``img_align_celeba/`` JPEGs +
    optional ``list_eval_partition.txt``), the local-file analog of the
    reference's tfds ``celeb_a`` loader (``cifar/datasets.py:126-135``).

    Partition codes follow the official file: 0=train, 1=validation,
    2=test; the validation set fills the eval slot (the reference's
    ``eval_split_name = 'validation'``). Without a partition file, the
    last 10% of the sorted filenames serve as validation. CelebA carries
    no class label in this pipeline — labels are zeros, so the class-
    filter split DSL is a no-op, exactly as with tfds celeb_a. Images are
    decoded with PIL at their aligned 178x218 size; the celeba
    ``central_crop(140)`` + resize happens downstream in ``batches()``.
    """
    root = os.path.join(data_dir, "celeba")
    img_dir = os.path.join(root, "img_align_celeba")
    if not os.path.isdir(img_dir):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if not names:
        return None
    part_path = os.path.join(root, "list_eval_partition.txt")
    if os.path.exists(part_path):
        parts = {}
        with open(part_path) as f:
            for line in f:
                fields = line.split()
                if len(fields) == 2:
                    parts[fields[0]] = int(fields[1])
        train_names = [n for n in names if parts.get(n, 0) == 0]
        val_names = [n for n in names if parts.get(n, 0) == 1]
    else:
        cut = max(len(names) - max(len(names) // 10, 1), 1)
        train_names, val_names = names[:cut], names[cut:]

    def load(subset):
        imgs = np.stack([
            np.asarray(Image.open(os.path.join(img_dir, n)).convert("RGB"))
            for n in subset
        ])
        return imgs, np.zeros(len(imgs), np.int64)

    train_x, train_y = load(train_names)
    val_x, val_y = load(val_names)
    return train_x, train_y, val_x, val_y


def _synthetic_images(shape=(32, 32, 3), n_train=50_000, n_test=10_000, seed=0):
    """Deterministic class-structured stand-in (shapes/labels per dataset)."""
    rng = np.random.default_rng(seed)
    def make(n):
        y = rng.integers(0, 10, size=n)
        base = (y[:, None, None, None] * 25).astype(np.uint8)
        x = base + rng.integers(0, 64, size=(n,) + shape).astype(np.uint8)
        return x, y
    tr = make(n_train)
    te = make(n_test)
    return tr[0], tr[1], te[0], te[1]


def _resize_bilinear(imgs: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Batched (N,H,W,C) float bilinear resample, half-pixel-centered."""
    n, h, w, c = imgs.shape
    if (h, w) == (out_h, out_w):
        return imgs
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(imgs.dtype)[None, :, None, None]
    wx = (xs - x0).astype(imgs.dtype)[None, None, :, None]
    top = imgs[:, y0][:, :, x0] * (1 - wx) + imgs[:, y0][:, :, x1] * wx
    bot = imgs[:, y1][:, :, x0] * (1 - wx) + imgs[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _central_crop(imgs: np.ndarray, size: int) -> np.ndarray:
    """Reference ``central_crop`` (cifar/datasets.py:61-65), batched."""
    top = (imgs.shape[1] - size) // 2
    left = (imgs.shape[2] - size) // 2
    return imgs[:, top : top + size, left : left + size]


# name -> (local loader, synthetic shape, eval split base, default image_size,
#          celeba-style crop size or None) — cifar/datasets.py:98-137
_DATASETS = {
    "cifar10": (_load_cifar10_local, (32, 32, 3), "test", 32, None),
    "mnist": (_load_mnist_local, (28, 28, 1), "test", 28, None),
    "svhn": (_load_svhn_local, (32, 32, 3), "test", 32, None),
    "celeba": (_load_celeba_local, (218, 178, 3), "validation", 64, 140),
}


class ImageDataset:
    """In-memory image dataset with an infinite shuffled batch iterator."""

    def __init__(
        self,
        name: str = "cifar10",
        split: str = "train",
        data_dir: Optional[str] = None,
        seed: int = 0,
        image_size: Optional[int] = None,
    ):
        key = name.lower()
        if key not in _DATASETS:
            raise NotImplementedError(
                f"Dataset {name} not yet supported."  # cifar/datasets.py:136-137
            )
        loader, shape, _eval_base, default_size, crop = _DATASETS[key]
        data_dir = data_dir or os.environ.get("SUPERDIFF_DATA_DIR")
        loaded = loader(data_dir) if data_dir else None
        self.synthetic = loaded is None
        if loaded is None:
            # celeba stand-in kept small: full-size synthetic would be GBs
            n_tr, n_te = (50_000, 10_000) if key != "celeba" else (1_000, 500)
            loaded = _synthetic_images(shape, n_train=n_tr, n_test=n_te)
        train_x, train_y, test_x, test_y = loaded
        spec = SplitSpec.parse(split)
        x, y = (train_x, train_y) if spec.base == "train" else (test_x, test_y)
        self.images, self.labels = spec.apply(x, y)
        self.seed = seed
        self.crop = crop
        self.image_size = image_size or default_size

    def __len__(self):
        return len(self.images)

    def batches(
        self,
        batch_size: int,
        *,
        uniform_dequantization: bool = True,
        random_flip: bool = True,
        scale_to_pm1: bool = True,
        loop: bool = True,
    ) -> Iterator[dict]:
        """Yield {'image': (B,H,W,C) float32, 'label': (B,) int32} forever."""
        rng = np.random.default_rng(self.seed)
        n = len(self.images)
        s = self.image_size
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = perm[i : i + batch_size]
                img = self.images[idx].astype(np.float32)
                if self.crop is not None:  # celeba: central_crop(140) first
                    img = _central_crop(img, self.crop)
                if img.shape[1] != s or img.shape[2] != s:
                    # reference resizes the [0,1] float image then dequantizes
                    # (u + img*255)/256 (cifar/datasets.py:141-148); for the
                    # native-size case this reduces to (uint + u)/256 below
                    img = _resize_bilinear(img, s, s)
                if uniform_dequantization:
                    img = (img + rng.uniform(size=img.shape).astype(np.float32)) / 256.0
                else:
                    img = img / 255.0
                if random_flip:
                    flip = rng.random(batch_size) < 0.5
                    img[flip] = img[flip, :, ::-1]
                if scale_to_pm1:
                    img = img * 2.0 - 1.0
                yield {"image": img, "label": self.labels[idx].astype(np.int32)}
            if not loop:
                return


class PrefetchIterator:
    """Background-thread prefetcher: overlaps host batch prep (dequantize,
    flip, scale) with device compute. The reference leans on tf.data's
    threading (``cifar/datasets.py:156-158``); this is the dependency-free
    equivalent for the numpy pipeline. :meth:`close` stops the thread (an
    endless source would otherwise keep it, and its dataset, alive)."""

    def __init__(self, iterator, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not put(item):
                        return
            finally:
                put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


def get_image_scaler(centered: bool = True):
    return (lambda x: x * 2.0 - 1.0) if centered else (lambda x: x)


def get_image_inverse_scaler(centered: bool = True):
    return (lambda x: (x + 1.0) / 2.0) if centered else (lambda x: x)
