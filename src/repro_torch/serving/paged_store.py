"""Physical KV page pool in PyTorch: the port of the JAX package's
``PagedKVStore`` (``repro/serving/kvcache.py``).

A pool of shape (L, n_pages, page_size, Hkv, D) per K and V. Pages come
from the copied ``BlockAllocator``; its ``table(rid, max_pages)`` rows
(-1 past a request's pages), stacked over requests, are the block tables
the paged-decode op takes over ``k_pages[l]`` / ``v_pages[l]``::

    tables = torch.as_tensor(np.stack([store.allocator.table(r, P)
                                       for r in rids]))
    out = ops.paged_attention_op(q, store.k_pages[l], store.v_pages[l],
                                 tables.to(q.device), lengths)

Writes are in place (the JAX store replaces its arrays). An e4m3 pool
takes e4m3 K/V as they are and casts others through ``layers.to_e4m3``,
the JAX package's cast (a magnitude over 464 becomes NaN, where torch's
cast saturates).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import to_e4m3
from repro_torch.serving.kvcache import BlockAllocator


@dataclasses.dataclass
class PagedKVStore:
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    allocator: BlockAllocator

    @classmethod
    def create(cls, num_layers: int, n_pages: int, page_size: int,
               num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda"):
        shape = (num_layers, n_pages, page_size, num_kv_heads, head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            allocator=BlockAllocator(n_pages, page_size),
        )

    def write_tokens(self, rid: int, pos: int, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """k/v: (L, T, Hkv, D) new tokens for request ``rid`` starting at
        logical position ``pos``. Allocates pages as needed; raises
        ``MemoryError`` when the pool cannot hold them."""
        t = k.shape[1]
        ps = self.allocator.block_size
        if not self.allocator.extend(rid, pos + t):
            raise MemoryError(f"KV pool exhausted for rid={rid}")
        logical = torch.arange(pos, pos + t)
        pages = torch.as_tensor(self.allocator.allocated[rid])[logical // ps]
        pages, offs = pages.to(k.device), (logical % ps).to(k.device)
        for pool, new in ((self.k_pages, k), (self.v_pages, v)):
            if pool.dtype == torch.float8_e4m3fn:
                if new.dtype != pool.dtype:
                    new = to_e4m3(new)
                pool.view(torch.uint8)[:, pages, offs] = new.view(torch.uint8)
            else:
                pool[:, pages, offs] = new.to(pool.dtype)

    def gather_dense(self, rid: int, length: int):
        """(L, length, Hkv, D) dense view of ``rid``'s tokens (a copy)."""
        pages = torch.as_tensor(self.allocator.allocated[rid],
                                device=self.k_pages.device)
        l, _, ps, hkv, d = self.k_pages.shape

        def dense(pool):
            return pool[:, pages].reshape(l, -1, hkv, d)[:, :length]

        return dense(self.k_pages), dense(self.v_pages)
