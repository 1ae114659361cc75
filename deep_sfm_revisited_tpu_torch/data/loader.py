"""Threaded prefetching batch loader.

The PyTorch port's verbatim copy of `deep_sfm_revisited_tpu/data/loader.py`
(the port imports nothing of the JAX package).

Replaces the reference's torch DataLoader (8 workers, pinned memory,
`main.py:86,186-189`) with a python-thread prefetcher: worker threads
decode/augment samples (numpy releases the GIL in the heavy ops), a
collator pads each batch to /pad_multiple (≙ `main.py:315-338`) and
stacks, and up to `prefetch` ready batches sit in a queue so the TPU
never waits on the host. Per-host sharding for multi-host runs: pass
(shard_id, num_shards) to stride the index space.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def pad_to_multiple(
    arr: np.ndarray, multiple: int, mode: str = "edge"
) -> np.ndarray:
    """Pad H, W (leading two dims) up to a multiple.

    Images are replicate-padded (≙ `main.py:494-500`, F.pad 'replicate');
    GT depth is ZERO-padded — padded rows/cols must stay outside the
    (gt > 0) eval mask, and the reference never pads GT at all (it
    evaluates at raw size, `main.py:543,568-574`)."""
    h, w = arr.shape[:2]
    H = int(np.ceil(h / multiple) * multiple)
    W = int(np.ceil(w / multiple) * multiple)
    if (H, W) == (h, w):
        return arr
    pad = [(0, H - h), (0, W - w)] + [(0, 0)] * (arr.ndim - 2)
    if mode == "edge":
        return np.pad(arr, pad, mode="edge")
    return np.pad(arr, pad, mode="constant", constant_values=0)


def collate(samples: List[Dict], pad_multiple: int = 0) -> Dict[str, np.ndarray]:
    """Stack samples; pad image/depth keys to /pad_multiple and record each
    sample's pre-pad raw (h, w) as `raw_hw` (B, 2) int32 so the eval
    protocol can crop back (≙ `main.py:492-496` height_raw/width_raw)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) and vals[0].ndim >= 2 and pad_multiple:
            if key in ("ref", "target"):
                vals = [pad_to_multiple(v, pad_multiple) for v in vals]
            elif key == "depth_gt":
                out["raw_hw"] = np.asarray(
                    [v.shape[:2] for v in vals], np.int32
                )
                vals = [
                    pad_to_multiple(v, pad_multiple, mode="zeros")
                    for v in vals
                ]
        out[key] = np.stack(vals)
    return out


class BatchLoader:
    """Iterable over collated batches with background workers."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        workers: int = 8,
        prefetch: int = 4,
        pad_multiple: int = 128,
        drop_last: bool = True,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(workers, 1)
        self.prefetch = prefetch
        self.pad_multiple = pad_multiple
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._epoch = 0

    def __len__(self):
        # every shard yields ceil(N / num_shards) samples (wrap-around
        # padding, torch DistributedSampler style) so multi-host epochs
        # are the same length on every process and no tail sample is
        # silently dropped from a sharded eval
        n = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(idx)
        valid = None
        if self.num_shards > 1:
            # wrap-around pad so every shard sees the same sample count
            # (the duplicated head samples are the standard
            # DistributedSampler trade for equal-length shards). Each
            # duplicate is FLAGGED (`sample_valid` 0) so sharded eval
            # excludes it from the metric sums instead of double-counting
            # up to num_shards-1 samples (ADVICE r3).
            n_real = len(idx)
            total = -(-n_real // self.num_shards) * self.num_shards
            idx = np.resize(idx, total)  # cyclic repeat up to total
            valid = np.ones(total, np.float32)
            valid[n_real:] = 0.0
            valid = valid[self.shard_id :: self.num_shards]
        idx = idx[self.shard_id :: self.num_shards]
        nb = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        valids = (
            [valid[i * self.batch_size : (i + 1) * self.batch_size]
             for i in range(nb)]
            if valid is not None else [None] * nb
        )

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        job_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            job_q.put((bi, b, valids[bi]))
        results: Dict[int, Dict] = {}
        lock = threading.Lock()
        stop = threading.Event()

        def worker(wid: int):
            wrng = np.random.default_rng((self.seed, self._epoch, wid))
            while not stop.is_set():
                try:
                    bi, b, bv = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    samples = [
                        self.dataset.__getitem__(int(i), rng=wrng) for i in b
                    ]
                    batch = collate(samples, self.pad_multiple)
                    if bv is not None:
                        batch["sample_valid"] = np.asarray(bv, np.float32)
                except Exception as e:  # surface loader errors, don't hang
                    batch = e
                with lock:
                    results[bi] = batch

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.workers)
        ]
        for t in threads:
            t.start()

        try:
            for bi in range(nb):
                while True:
                    with lock:
                        if bi in results:
                            batch = results.pop(bi)
                            break
                    threading.Event().wait(0.002)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
