"""Per-client batching with heterogeneous batch sizes (port of
`repro.data.pipeline`; the host side is the reference's numpy, verbatim).

HASFL assigns a different b_i to every client each round.  The stacked
[N, b, ...] batch needs one shape, so batches are padded to ``b_max`` with a ``loss_mask``
(the padded-sample gradient contribution is exactly zero; the mean is taken
over real samples only — per-client SGD semantics preserved).

Two feeding paths share one host RNG routine (``draw_indices``):

- **ClientSampler** — host batches: draw indices, gather on host,
  zero-pad (it also owns the arrays, shard pools and RNG the store
  shares).
- **DeviceClientStore** — the simulator's path: the dataset is uploaded
  once at construction and stays device-resident; the host RNG stream
  remains authoritative by pre-generating the tiny ``[R, N, b_pad]``
  int32 index tensor per segment (same draws, same order, bitwise-identical
  sampling), and per-round batches are gathered *on device* with
  ``index_select`` (DESIGN.md §8).

The grid runner folds G cells of N clients into one ``[G·N, ...]`` batch:
`DeviceClientStore.fold_plan` turns the cells' plans into one, and
`DeviceClientStore.stack_arrays` lays seed-crossing cells' own arrays end
to end, so ``device_batch`` gathers every cell's batch in one call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def draw_indices(rng: np.random.Generator, pool: np.ndarray,
                 batch: int) -> np.ndarray:
    """Draw one client's round indices from its shard pool.

    The single authoritative sampling routine: ``ClientSampler.sample``
    and ``DeviceClientStore.segment_indices`` both consume the host RNG
    through this function, so the two feeding paths see bitwise-identical
    index streams when called in the same (round, client) order.
    """
    return rng.choice(pool, size=min(batch, len(pool)),
                      replace=len(pool) < batch)


class ClientSampler:
    def __init__(self, arrays: dict, client_indices: list,
                 rng: np.random.Generator):
        """arrays: name -> np.ndarray with leading sample axis."""
        self.arrays = arrays
        self.client_indices = client_indices
        self.rng = rng

    @property
    def n_clients(self) -> int:
        return len(self.client_indices)

    def sample(self, client: int, batch: int, pad_to: Optional[int] = None):
        take = draw_indices(self.rng, self.client_indices[client], batch)
        out = {k: v[take] for k, v in self.arrays.items()}
        n = len(take)
        pad_to = pad_to or n
        if pad_to > n:
            pad = pad_to - n
            out = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in out.items()}
        # loss mask: [pad_to] for images, [pad_to, S] for token data
        if "tokens" in out:
            mask = np.zeros(out["tokens"].shape, np.float32)
            mask[:n] = 1.0
        else:
            mask = np.zeros((pad_to,), np.float32)
            mask[:n] = 1.0
        out["loss_mask"] = mask
        return out


class DeviceClientStore:
    """Device-resident dataset feeding the simulator's segments.

    Uploads every data array once (the leading axis indexes samples
    globally, exactly as ``ClientSampler.arrays``), then serves whole
    training segments as index plans: ``segment_indices`` pre-draws the
    ``[R, N, b_pad]`` int32 round/client/sample gather plan on the host —
    consuming the *same* RNG stream as ``ClientSampler`` in the same
    (round, client) order — and ``device_batch`` turns one ``[N, b_pad]``
    slice of it into the padded per-client batch on device.  Padded rows
    are zeroed (not just masked), matching the host zero-padding path.
    """

    def __init__(self, arrays: dict, client_indices: list,
                 rng: np.random.Generator, device=None):
        self.arrays = {k: torch.as_tensor(np.asarray(v)).to(device)
                       for k, v in arrays.items()}
        self.client_indices = [np.asarray(p) for p in client_indices]
        self.rng = rng

    @classmethod
    def from_sampler(cls, sampler: ClientSampler,
                     device=None) -> "DeviceClientStore":
        """Share the sampler's arrays *and its RNG object*, so the host
        stream stays authoritative."""
        return cls(sampler.arrays, sampler.client_indices, sampler.rng,
                   device)

    @property
    def n_clients(self) -> int:
        return len(self.client_indices)

    @staticmethod
    def stack_arrays(stores) -> dict:
        """The member stores' arrays end to end, ``[G·n_train, ...]``: cell
        g's samples at rows ``[g·n_train, (g+1)·n_train)``, for grid cells
        that read their own data (different seeds).  All stores must hold
        the same keys and shapes (``grid_key`` pins n_train and the arch,
        which is what guarantees it)."""
        keys = set(stores[0].arrays)
        for s in stores[1:]:
            if set(s.arrays) != keys or any(
                s.arrays[k].shape != stores[0].arrays[k].shape for k in keys
            ):
                raise ValueError(
                    "stack_arrays needs same-keyed, same-shaped stores "
                    "(grid cells must share data shapes)"
                )
        return {k: torch.cat([s.arrays[k] for s in stores]) for k in keys}

    @staticmethod
    def fold_plan(idx, row_mask, n_train: Optional[int] = None):
        """G cells' segment plans ``[G, R, N, b_pad]`` and row masks ``[G,
        N, b_pad]`` (host arrays) -> the folded ``[R, G·N, b_pad]`` plan and
        ``[G·N, b_pad]`` mask, cell after cell.  With ``n_train`` (arrays
        from `stack_arrays`) cell g's indices move by ``g·n_train`` to its
        own samples; without, every cell reads the one store's arrays.
        Padded columns keep their zero mask, so ``device_batch`` zeroes
        them whatever they gather."""
        idx = np.asarray(idx, np.int64)
        g, r, n, b_pad = idx.shape
        if n_train is not None:
            idx = idx + (np.arange(g) * n_train)[:, None, None, None]
        plan = idx.transpose(1, 0, 2, 3).reshape(r, g * n, b_pad)
        return plan, np.asarray(row_mask).reshape(g * n, b_pad)

    def set_pool(self, slot: int, indices) -> None:
        """Rebind one client slot's shard pool (the cohort bank's slot
        surgery).  Only the *values* future `segment_indices` plans
        gather change; every tensor shape is a function of (N, b_pad).
        Pools must stay non-empty: an empty pool would make the slot's
        gradient NaN, which poisons the weighted survivor mean even at
        weight 0 (``0 * NaN``)."""
        idx = np.asarray(indices)
        if idx.size == 0:
            raise ValueError("slot pools must be non-empty")
        self.client_indices[int(slot)] = idx

    def real_counts(self, b) -> np.ndarray:
        """Per-client real (unpadded) sample count: min(b_i, |pool_i|)."""
        pools = np.asarray([len(p) for p in self.client_indices])
        return np.minimum(np.asarray(b, int), pools)

    def segment_indices(self, rounds: int, b, pad_to: int) -> np.ndarray:
        """Pre-draw the [rounds, N, pad_to] int32 gather plan for a segment.

        Row (r, i) holds client i's round-r sample indices in columns
        [0, n_i); padding columns gather sample 0 and are zeroed again by
        the row mask inside ``device_batch``.
        """
        n = self.n_clients
        b_arr = np.asarray(b, int)
        idx = np.zeros((rounds, n, pad_to), np.int32)
        for r in range(rounds):
            for i, pool in enumerate(self.client_indices):
                take = draw_indices(self.rng, pool, int(b_arr[i]))
                idx[r, i, :len(take)] = take
        return idx

    def row_mask(self, b, pad_to: int) -> np.ndarray:
        """[N, pad_to] 1.0/0.0 real-sample mask for a segment's batches."""
        counts = self.real_counts(b)
        return (np.arange(pad_to)[None, :] < counts[:, None]).astype(
            np.float32)

    @staticmethod
    def device_batch(arrays: dict, idx, row_mask) -> dict:
        """Gather one round's padded per-client batch on device.

        ``idx``: [N, b_pad] integer tensor, ``row_mask``: [N, b_pad] float
        tensor, both on the arrays' device.  Padded rows are forced to
        exact zeros (select, not multiply: a non-finite value in the
        gathered index-0 sample must not poison padded rows), and the loss
        mask is the row mask in the sampler's shape convention: ``[N, b,
        S]`` for token data, ``[N, b]`` otherwise.
        """
        batch = {}
        keep = row_mask > 0
        for k, v in arrays.items():
            g = v.index_select(0, idx.reshape(-1)).reshape(
                tuple(idx.shape) + tuple(v.shape[1:]))
            m = keep.reshape(tuple(keep.shape) + (1,) * (g.dim() - 2))
            batch[k] = torch.where(m, g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
        mask = row_mask.to(torch.float32)
        if "tokens" in batch:
            mask = mask[:, :, None].expand(batch["tokens"].shape)
        batch["loss_mask"] = mask
        return batch
