"""Two-domain batch pipeline: the port's copy of the JAX package's
``data/pipeline.py``, batch for batch.

As the reference's tf.data pipeline:
- both train domains truncated to min(|trainA|, |trainB|),
- ceil(n / batch) steps an epoch,
- per-domain preprocess -> cache -> shuffle; with ``cache_augmented`` the
  augmentations of epoch 0 are cached and reused by every epoch (the
  reference's cache-after-augment quirk), without it each epoch draws its
  own,
- the two domains zipped batch by batch,
- the first ``plot_samples`` test pairs at batch 1 for the cycle plots.

As the JAX package does beyond the reference:
- every batch has the same shape: the last, ragged one is zero-padded to
  the batch size, with {0, 1} per-sample weights;
- the shuffle is a full seeded permutation per epoch and domain;
- the caches hold uint8 (a quarter of float32), normalised as each batch
  is assembled; ``cache_nbytes()`` counts them;
- one RNG stream per (seed, split, epoch, index) decides each training
  image's flip and crop, for the native and the numpy path alike.

The port runs one process, so a batch is never split between hosts.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.data import native
from cyclegan_tpu_torch.data.augment import (
    draw_augment_params,
    normalize_image,
    preprocess_test,
    preprocess_train,
)
from cyclegan_tpu_torch.data.prefetch import prefetch_iter
from cyclegan_tpu_torch.data.sources import Source, resolve_source, split_tag

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # x, y, weights


class CycleGANData:
    """Preprocessed two-domain dataset with epoch iterators.
    ``preprocessing`` says which path the training images take: "native"
    where the C++ library builds, else "numpy"."""

    # Native preprocessing window: bounds the raw uint8 stack held at once.
    _NATIVE_WINDOW = 256

    def __init__(self, config: Config, global_batch_size: int,
                 source: Optional[Source] = None,
                 test_batch_size: Optional[int] = None):
        c = config.data
        self.config = config
        self.global_batch_size = int(global_batch_size)
        self.test_batch_size = int(test_batch_size or global_batch_size)
        self.source = source or resolve_source(c)
        self.seed = config.train.seed
        self.preprocessing = "native" if native.available() else "numpy"

        self.n_train = min(self.source.split_size("trainA"),
                           self.source.split_size("trainB"))
        self.n_test = min(self.source.split_size("testA"),
                          self.source.split_size("testB"))
        self.train_steps = math.ceil(self.n_train / self.global_batch_size)
        self.test_steps = math.ceil(self.n_test / self.test_batch_size)

        self._test_a = self._prep_test("testA")
        self._test_b = self._prep_test("testB")
        self._train_cache: Optional[Tuple[List[np.ndarray],
                                          List[np.ndarray]]] = None
        if c.cache_augmented:
            self._train_cache = (self._prep_train("trainA", epoch=0),
                                 self._prep_train("trainB", epoch=0))

    # -- preprocessing ---------------------------------------------------

    def _prep_test(self, split: str) -> List[np.ndarray]:
        crop = self.config.data.crop_size
        return [preprocess_test(self.source.load(split, i), crop,
                                normalize=False)
                for i in range(self.n_test)]

    def _sample_rng(self, split: str, epoch: int, i: int) -> np.random.Generator:
        """The one RNG stream of (seed, split, epoch, sample)."""
        return np.random.default_rng((self.seed, split_tag(split), epoch, i))

    def _augment_one(self, split: str, epoch: int, i: int,
                     raw: Optional[np.ndarray] = None) -> np.ndarray:
        """One augmented image in the uint8 cache format."""
        c = self.config.data
        raw = self.source.load(split, int(i)) if raw is None else raw
        return preprocess_train(
            raw, self._sample_rng(split, epoch, int(i)), c.resize_size,
            c.crop_size, use_native=self.preprocessing == "native",
            normalize=False, allow_flip=c.augment_flip)

    def _prep_train(self, split: str, epoch: int) -> List[np.ndarray]:
        c = self.config.data
        if self.preprocessing == "numpy":
            return [self._augment_one(split, epoch, i)
                    for i in range(self.n_train)]
        out: List[np.ndarray] = []
        for lo in range(0, self.n_train, self._NATIVE_WINDOW):
            hi = min(lo + self._NATIVE_WINDOW, self.n_train)
            raws = [self.source.load(split, i) for i in range(lo, hi)]
            if len({r.shape for r in raws}) != 1:
                # Mixed sizes: one image at a time.
                out.extend(self._augment_one(split, epoch, i, raws[i - lo])
                           for i in range(lo, hi))
                continue
            flips, oys, oxs = [], [], []
            for i in range(lo, hi):
                f, oy, ox = draw_augment_params(
                    self._sample_rng(split, epoch, i), c.resize_size,
                    c.crop_size)
                flips.append(int(f and c.augment_flip))
                oys.append(oy)
                oxs.append(ox)
            out.extend(native.preprocess_batch(
                np.stack(raws), c.resize_size, np.asarray(flips, np.int32),
                np.asarray(oys, np.int32), np.asarray(oxs, np.int32),
                c.crop_size, normalize=False))
        return out

    # -- iteration -------------------------------------------------------

    def _epoch_order(self, epoch: int, domain: int, n: int) -> np.ndarray:
        """The seeded permutation of one epoch and domain."""
        rng = np.random.default_rng((self.seed, 0xD0 + domain, epoch))
        return rng.permutation(n)

    def _batches(self, get_a, get_b, order_a: np.ndarray,
                 order_b: np.ndarray, gbs: Optional[int] = None
                 ) -> Iterator[Batch]:
        """(x, y, weights) batches of ``gbs``, the last zero-padded with
        zero weights. ``get_a``/``get_b`` map an index to a uint8 image and
        run lazily, inside the prefetch thread where there is one."""
        gbs = gbs or self.global_batch_size
        crop = self.config.data.crop_size
        for start in range(0, len(order_a), gbs):
            ga = order_a[start:start + gbs]
            gb = order_b[start:start + gbs]
            k = len(ga)
            weights = np.zeros((gbs,), np.float32)
            weights[:k] = 1.0
            if k < gbs:
                pad = np.zeros((gbs - k,), np.int64)
                ga = np.concatenate([ga, pad])
                gb = np.concatenate([gb, pad])
            x = normalize_image(np.stack([get_a(i) for i in ga]))
            y = normalize_image(np.stack([get_b(i) for i in gb]))
            if k < gbs:
                x = x * weights[:, None, None, None]
                y = y * weights[:, None, None, None]
            assert x.shape[1:] == (crop, crop, 3)
            yield x, y, weights

    def restore_seed(self, seed: int) -> None:
        """Take the data seed a mid-epoch checkpoint recorded, rebuilding
        the cached augmentations where it differs from this one's, so a
        resumed run replays the saved run's permutations and crops."""
        seed = int(seed) % (1 << 32)
        if seed == self.seed:
            return
        self.seed = seed
        if self._train_cache is not None:
            self._train_cache = (self._prep_train("trainA", epoch=0),
                                 self._prep_train("trainB", epoch=0))

    def train_epoch(self, epoch: int, prefetch: bool = True,
                    start_step: int = 0) -> Iterator[Batch]:
        """The epoch's batches; from ``start_step`` on, exactly batches
        ``start_step``.. of the whole epoch (a mid-epoch resume): the
        permutations are cut by whole batches."""
        if self._train_cache is not None:
            get_a = self._train_cache[0].__getitem__
            get_b = self._train_cache[1].__getitem__
        else:
            def get_a(i):
                return self._augment_one("trainA", epoch, i)

            def get_b(i):
                return self._augment_one("trainB", epoch, i)
        skip = int(start_step) * self.global_batch_size
        it = self._batches(get_a, get_b,
                           self._epoch_order(epoch, 0, self.n_train)[skip:],
                           self._epoch_order(epoch, 1, self.n_train)[skip:])
        return prefetch_iter(it, depth=2) if prefetch else it

    def test_epoch(self, prefetch: bool = True) -> Iterator[Batch]:
        order = np.arange(self.n_test)
        it = self._batches(self._test_a.__getitem__, self._test_b.__getitem__,
                           order, order, gbs=self.test_batch_size)
        return prefetch_iter(it, depth=2) if prefetch else it

    def plot_pairs(self, k: Optional[int] = None
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The first k test pairs at batch 1, normalised."""
        k = k if k is not None else self.config.train.plot_samples
        k = min(k, self.n_test)
        return [(normalize_image(self._test_a[i][None, ...]),
                 normalize_image(self._test_b[i][None, ...]))
                for i in range(k)]

    def cache_nbytes(self) -> int:
        """Bytes held by the test and train caches."""
        total = sum(a.nbytes for a in self._test_a + self._test_b)
        if self._train_cache is not None:
            total += sum(a.nbytes for items in self._train_cache
                         for a in items)
        return total


def build_data(config: Config, global_batch_size: int,
               test_batch_size: Optional[int] = None) -> CycleGANData:
    return CycleGANData(config, global_batch_size,
                        test_batch_size=test_batch_size)
