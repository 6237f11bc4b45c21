"""Host-side batching for array datasets, ported from
``explainable_spatial_vqa_tpu/train/data.py``.

Split membership reproduces sklearn's ``train_test_split(random_state=seed)``
with numpy alone, and each epoch's shuffle is
``RandomState(seed + epoch)``, so both packages draw the same batches.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.parallel.multihost import host_batch_slice

__all__ = ["train_val_test_split", "batches", "Subset"]


def train_val_test_split(n: int, test_fraction: float = 0.1, val_fraction: float = 0.1,
                         seed: int = 42) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn's split: shuffle with ``RandomState(seed).permutation`` and take
    the first ``ceil(n * test_size)`` as the test split, then split train and
    validation the same way with a fresh ``RandomState(seed)``."""

    def split(indices: np.ndarray, test_size: float):
        n_test = int(np.ceil(len(indices) * test_size))
        perm = np.random.RandomState(seed).permutation(len(indices))
        return indices[perm[n_test:]], indices[perm[:n_test]]

    train_val, test = split(np.arange(n), test_fraction)
    train, val = split(train_val, val_fraction / (1.0 - test_fraction))
    return train, val, test


class Subset:
    """View over a dict-of-arrays dataset through an index array."""

    def __init__(self, arrays: Dict[str, np.ndarray], indices: np.ndarray):
        self.arrays = arrays
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def gather(self, batch_indices: np.ndarray) -> Dict[str, np.ndarray]:
        idx = self.indices[batch_indices]
        return {k: v[idx] for k, v in self.arrays.items()}


def batches(
    data: Subset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    transform: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dict batches in the order of ``RandomState(seed + epoch)`` (or in
    order without ``shuffle``); ``drop_last`` keeps every batch one shape.

    Data parallel over ``process_count`` processes: ``batch_size`` is
    GLOBAL; every process draws the same permutation and gathers only its
    own contiguous ``parallel.multihost.host_batch_slice`` rows of each
    global batch, which needs ``drop_last`` (a partial last batch would
    leave the processes with shards of different sizes).  One process is
    exactly the single-process behaviour."""
    n = len(data)
    order = np.random.RandomState(seed + epoch).permutation(n) if shuffle else np.arange(n)
    if process_count > 1 and not drop_last:
        raise ValueError("multi-host batches() requires drop_last=True")
    local = (host_batch_slice(batch_size, process_index, process_count) if process_count > 1
             else slice(None))
    limit = n - (n % batch_size) if drop_last else n
    for start in range(0, limit, batch_size):
        batch = data.gather(order[start:start + batch_size][local])
        if transform is not None:
            batch = transform(batch)
        yield batch
