"""Physical KV block pool — the device side of the paper's "physical
cache".

The pool owns ``n_blocks`` fixed-size pages per layer in device memory
(the single "slabclass" of the paper's evaluation setup); the host keeps
the free list and the block tables. The object-sharing LRU manager
(``prefix_cache.SharedPrefixCache``) decides residency. Pages are laid
out ``(L, KV, n_blocks, block_tokens, D)``: per layer, exactly the
``(KV, P, page, D)`` pool that :func:`repro_torch.kernels.ops.paged_attention`
reads through block tables. The serving engine only keeps the
accounting; a caller that decodes composes ``SharedPrefixCache.block_table``,
:meth:`BlockPool.layer_pool` and the kernels itself.

Unlike the reference, whose arrays are immutable, :meth:`write_block`
and :meth:`load_numpy` write into the pages in place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _pages_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Host tensor with ``a``'s bits. NumPy's bfloat16 (``ml_dtypes``,
    what ``np.asarray`` of a JAX bf16 array gives) is not a dtype
    ``torch.from_numpy`` takes, so it goes through int16, bit for bit."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # np.asarray of a JAX array is read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class BlockPool:
    def __init__(
        self,
        n_blocks: int,
        block_tokens: int,
        n_kv_heads: int,
        head_dim: int,
        n_layers: int,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
    ) -> None:
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.n_layers = n_layers
        self.device = resolve_device(device)
        # (L, KV, n_blocks, block_tokens, head_dim): per layer, the paged
        # kernel's (KV, P, page, D) pool layout.
        self.k_pages = torch.zeros(
            (n_layers, n_kv_heads, n_blocks, block_tokens, head_dim),
            dtype=dtype, device=self.device,
        )
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free: List[int] = list(range(n_blocks))
        self.high_water = 0

    # -- host-side accounting -------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: want {n}, free {len(self._free)}"
            )
        out = [self._free.pop() for _ in range(n)]
        self.high_water = max(self.high_water, self.used_blocks)
        return out

    def free(self, ids: Sequence[int]) -> None:
        self._free.extend(int(i) for i in ids)
        assert len(self._free) <= self.n_blocks

    # -- device-side writes (in place) ------------------------------------
    def write_block(
        self, layer: int, block_id: int, k: torch.Tensor, v: torch.Tensor
    ) -> None:
        """k, v: (block_tokens, KV, head_dim), cast to the pool's dtype and
        copied into page ``block_id`` of ``layer`` in place."""
        self.k_pages[layer, :, block_id].copy_(k.movedim(1, 0))
        self.v_pages[layer, :, block_id].copy_(v.movedim(1, 0))

    def layer_pool(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(KV, P, page, D) views consumed by ops.paged_attention."""
        return self.k_pages[layer], self.v_pages[layer]

    def load_numpy(self, k_pages: np.ndarray, v_pages: np.ndarray) -> None:
        """Copy a pool's pages, given as NumPy arrays of this pool's
        ``(L, KV, n_blocks, block_tokens, D)`` shape (for example
        ``np.asarray`` of the reference ``BlockPool``'s pages), into this
        pool in place. Pages of the pool's own dtype arrive bit for bit."""
        for dst, src in ((self.k_pages, k_pages), (self.v_pages, v_pages)):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"pages of shape {tuple(src.shape)} do not fit a pool of "
                    f"shape {tuple(dst.shape)}"
                )
            dst.copy_(_pages_from_numpy(src))
